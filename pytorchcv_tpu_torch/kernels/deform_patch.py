"""Bounded-offset modulated deformable sampling (K5): the taps of a 3x3,
stride-1, pad-1 deformable conv (DCNv2), each bilinearly sampled at its
offset position and multiplied by its mask, before the (9*C, O) product.

ProPainter's alignment (``models/propainter_rfc.py``) writes its offsets as
``center + residual`` with ``|residual| <= residue_bound`` (tanh-capped), so
every sample of a pixel lies in a (P, P) window, P = 2*ceil(bound) + 4,
around it. The TPU kernel this replaces (``pytorchcv_tpu/kernels/
deform_patch.py:deform_sample_patch``) staged that window in VMEM because
its gathers paid per index; the CUDA kernel (``csrc/deform_sample.cu``)
reads the four corners of each sample directly, which computes the same
function. Positions are f32 for bf16 data too; a corner outside the image
reads zero; the lerp runs along y, then along x.

The kernel takes x as it lies, channels-last or NCHW (then it transposes
x itself, in the same launch); a block covers :func:`deform_plan`'s pixels
and all nine taps, in vectors of :func:`vector_width` channels.

:func:`tap_positions` and :func:`bilinear_taps` are the plain version's
arithmetic; ``nn.deform``'s general route (any kernel size, stride,
padding and batch) shares them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import (LAUNCHES, autograd_records, check, device_of, library,
                     require_cuda_or_cpu, stream_of)

__all__ = ["deform_sample", "deform_sample_reference", "tap_positions",
           "bilinear_taps", "window_size", "deform_plan", "vector_width",
           "kernel_info"]

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_SAMPLES = 2048            # csrc/deform_sample.cu's staged samples a tile


def window_size(residue_bound: float) -> int:
    """P: the side of the window that holds every sample of a pixel."""
    return 2 * math.ceil(residue_bound) + 4


def tap_positions(offset: torch.Tensor, mask: torch.Tensor, groups: int,
                  kernel_size, stride: int, padding: int, dtype):
    """Absolute f32 sample positions and modulation of every (output pixel,
    tap, group): ``offset`` (B, 2*G*K2, Ho, Wo) with (y, x) pairs per
    (group, tap), ``mask`` (B, G*K2, Ho, Wo) -> ``py``, ``px``, ``m``, each
    (B, Ho*Wo, K2, G). The mask is rounded to ``dtype`` (x's type) first."""
    kh, kw = kernel_size
    k2 = kh * kw
    b, _, ho, wo = offset.shape
    dev = offset.device
    off = offset.to(torch.float32).reshape(b, groups, k2, 2, ho, wo)
    off = off.permute(0, 4, 5, 2, 1, 3).reshape(b, ho * wo, k2, groups, 2)
    ky = torch.arange(kh, device=dev).repeat_interleave(kw)
    kx = torch.arange(kw, device=dev).repeat(kh)
    oy = torch.arange(ho, device=dev) * stride - padding
    ox = torch.arange(wo, device=dev) * stride - padding
    base_y = (oy[:, None, None] + ky).expand(ho, wo, k2).reshape(-1, k2)
    base_x = (ox[None, :, None] + kx).expand(ho, wo, k2).reshape(-1, k2)
    py = base_y.to(torch.float32)[None, :, :, None] + off[..., 0]
    px = base_x.to(torch.float32)[None, :, :, None] + off[..., 1]
    m = mask.to(dtype).to(torch.float32).reshape(b, groups, k2, ho * wo)
    return py, px, m.permute(0, 3, 2, 1)


def bilinear_taps(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """``x`` (B, C, H, W) sampled at ``py``, ``px`` and times ``m`` (each
    (B, N, K2, G)) -> (B, N, K2, C) f32, channels g-major within a tap.
    Four corner reads (zero outside the image), a lerp along y, then along
    x, then the mask, each step in f32."""
    b, c, h, w = x.shape
    _, n, k2, g = py.shape
    cg = c // g
    xg = x.to(torch.float32).reshape(b, g, cg, h * w).transpose(2, 3)
    y0, x0 = torch.floor(py), torch.floor(px)

    def flat(a):        # (B, N, K2, G) -> (B, G, N*K2, 1)
        return a.permute(0, 3, 1, 2).reshape(b, g, n * k2, 1)

    def corner(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        v = torch.gather(xg, 2, flat(idx).expand(-1, -1, -1, cg))
        return v * flat(valid)

    fy, fx = flat(py - y0), flat(px - x0)
    gy, gx = 1.0 - fy, 1.0 - fx
    r0 = gy * corner(y0, x0) + fy * corner(y0 + 1, x0)
    r1 = gy * corner(y0, x0 + 1) + fy * corner(y0 + 1, x0 + 1)
    s = (gx * r0 + fx * r1) * flat(m)
    return s.reshape(b, g, n, k2, cg).permute(0, 2, 3, 1, 4).reshape(
        b, n, k2, c)


def deform_sample_reference(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, deform_groups: int
                            ) -> torch.Tensor:
    """Plain PyTorch version of K5 (the same f32 arithmetic): ``x``
    (1, C, H, W) -> (H*W, 9, C) in x's type."""
    py, px, m = tap_positions(offset, mask, deform_groups, (3, 3), 1, 1,
                              x.dtype)
    return bilinear_taps(x, py, px, m)[0].to(x.dtype)


@functools.lru_cache(maxsize=64)
def vector_width(cg: int, esize: int, misalign: int = 0) -> int:
    """Channels a vector: the widest of 16 bytes and its halves that
    divides a group's ``cg`` channels (so no vector straddles two groups)
    and to which the source is aligned (``misalign``: its address mod
    16). Cached: the wrapper asks once a call."""
    vec = 16 // esize
    while vec > 1 and (cg % vec or misalign % (vec * esize)):
        vec //= 2
    return vec


@functools.lru_cache(maxsize=64)
def deform_plan(h: int, w: int, groups: int) -> int:
    """Pixels a tile: the most, of 1, 2 and 4, whose 9 G samples a pixel
    fit a tile's staged samples (4 was the fastest at RFC's and the
    generator's shapes, f32 and bf16, channels-last and NCHW, but for the
    generator's NCHW f32 x, where the cooperative launch's resident blocks
    took 1.5 waves of tiles: the launch widens the tiles then;
    ``kernels/deform_stem_plans.py``). Cached."""
    fit = [n for n in (1, 2, 4) if 9 * groups * n <= _MAX_SAMPLES]
    return fit[-1] if fit else 1


def deform_sample(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  deform_groups: int, residue_bound: float) -> torch.Tensor:
    """K5: ``x`` (1, C, H, W) f32 or bf16 (NCHW or channels-last), ``offset``
    (1, 18*G, H, W), ``mask`` (1, 9*G, H, W) -> (H*W, 9, C) in x's type,
    tap-major and channels g-major within a tap, ready for the (9*C, O)
    weight matrix.

    The contract (checked): batch 1, C divisible by G, H and W at least
    P = 2*ceil(residue_bound) + 4. The caller's (not checked): every
    offset is a per-pixel center plus a residual of magnitude at most
    ``residue_bound``. CUDA tensors run the kernel (one launch, either
    layout of x), CPU tensors the plain version. A call that autograd would
    record raises (K5 has no backward; ``nn.deform.deform_conv2d`` takes its
    general route then)."""
    if x.dim() != 4 or x.shape[0] != 1 or x.dtype not in _DTYPES:
        raise ValueError(f"deform_sample: x must be (1, C, H, W) of "
                         f"{_DTYPES}, got {tuple(x.shape)} {x.dtype}")
    _, c, h, w = x.shape
    g = deform_groups
    p = window_size(residue_bound)
    if g < 1 or c % g or h < p or w < p:
        raise ValueError(f"deform_sample: needs C % G == 0 and H, W >= P = "
                         f"{p}, got C {c}, G {g}, H {h}, W {w}")
    if tuple(offset.shape) != (1, 18 * g, h, w) or \
            tuple(mask.shape) != (1, 9 * g, h, w):
        raise ValueError(f"deform_sample: offset {tuple(offset.shape)} and "
                         f"mask {tuple(mask.shape)} do not match x "
                         f"{tuple(x.shape)} with {g} groups")
    if autograd_records(x, offset, mask):
        raise ValueError("deform_sample: K5 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("deform_sample", x, offset, mask):
        return deform_sample_reference(x, offset, mask, g)
    if h * w * 9 * c >= 2 ** 31:
        raise ValueError("deform_sample: output exceeds 2**31 elements")
    if offset.dtype != torch.float32 or not offset.is_contiguous():
        offset = offset.to(torch.float32).contiguous()
    if mask.dtype != x.dtype or not mask.is_contiguous():
        mask = mask.to(x.dtype).contiguous()
    nhwc = x.is_contiguous(memory_format=torch.channels_last)
    if not nhwc and not x.is_contiguous():
        x = x.contiguous()
    return _launch(x, offset, mask, g, nhwc, deform_plan(h, w, g))


def _launch(x, offset, mask, g, nhwc, npix):
    """K5 on the card (checked operands) at ``npix`` pixels a tile
    (:func:`deform_plan`'s, or others for a sweep). An NCHW ``x`` is
    transposed by the same launch into a scratch (H*W, C) map behind the
    output (one allocation)."""
    _, c, h, w = x.shape
    esize = x.element_size()
    if nhwc:
        out = torch.empty((h * w, 9, c), dtype=x.dtype, device=x.device)
        src = x.data_ptr()
    else:      # the scratch map in ceil(H*W / 9) more output rows
        out = torch.empty((h * w - (-h * w // 9), 9, c), dtype=x.dtype,
                          device=x.device)
        src = out.data_ptr() + h * w * 9 * c * esize
        out = out[:h * w]
    vec = vector_width(c // g, esize, src % 16)
    with device_of(x):
        check(library().pcv_deform_sample(
            x.data_ptr(), src, offset.data_ptr(), mask.data_ptr(),
            out.data_ptr(), h, w, c, g, int(x.dtype == torch.bfloat16), npix,
            vec, int(nhwc), stream_of(x)), "deform_sample")
    LAUNCHES["deform_sample"] += 1
    return out


def kernel_info(c: int, groups: int, dtype, nhwc: bool) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of the K5 instance that C channels in ``groups``
    groups of ``dtype`` (aligned) launch, channels-last or NCHW, with its
    vector width (needs the card)."""
    esize = torch.empty((), dtype=dtype).element_size()
    vec = vector_width(c // groups, esize)
    out = (ctypes.c_int * 4)()
    check(library().pcv_deform_sample_info(
        int(dtype == torch.bfloat16), vec, int(nhwc), out),
        "deform_sample info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out), vec=vec)
