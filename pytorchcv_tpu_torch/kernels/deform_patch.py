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

:func:`tap_positions` and :func:`bilinear_taps` are the plain version's
arithmetic; ``nn.deform``'s general route (any kernel size, stride,
padding and batch) shares them.
"""

from __future__ import annotations

import math

import torch

from ._build import LAUNCHES, check, library, require_cuda_or_cpu, stream_of

__all__ = ["deform_sample", "deform_sample_reference", "tap_positions",
           "bilinear_taps", "window_size"]

_DTYPES = (torch.bfloat16, torch.float32)


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


def deform_sample(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  deform_groups: int, residue_bound: float) -> torch.Tensor:
    """K5: ``x`` (1, C, H, W) f32 or bf16, ``offset`` (1, 18*G, H, W),
    ``mask`` (1, 9*G, H, W) -> (H*W, 9, C) in x's type, tap-major and
    channels g-major within a tap, ready for the (9*C, O) weight matrix.

    The contract (checked): batch 1, C divisible by G, H and W at least
    P = 2*ceil(residue_bound) + 4. The caller's (not checked): every
    offset is a per-pixel center plus a residual of magnitude at most
    ``residue_bound``. CUDA tensors run the kernel, CPU tensors the plain
    version."""
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
    if not require_cuda_or_cpu("deform_sample", x, offset, mask):
        return deform_sample_reference(x, offset, mask, g)
    if h * w * 9 * c >= 2 ** 31:
        raise ValueError("deform_sample: output exceeds 2**31 elements")
    x_cl = x[0].permute(1, 2, 0).contiguous()
    off = offset.to(torch.float32).contiguous()
    m = mask.to(x.dtype).contiguous()
    out = torch.empty((h * w, 9, c), dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        check(lib.pcv_deform_sample(
            x_cl.data_ptr(), off.data_ptr(), m.data_ptr(), out.data_ptr(), h,
            w, c, g, int(x.dtype == torch.bfloat16), stream_of(x)),
            "deform_sample")
    LAUNCHES["deform_sample"] += 1
    return out
