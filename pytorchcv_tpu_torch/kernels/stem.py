"""The serving stems of the int8 pipelines (K3), and their int8 max-pool.

``stem_conv``: ``x`` planar bf16 (B, 3, H, W) is convolved with a BN-folded
bf16 kernel (k x k, stride 2, pad k // 2, with k = 7 for the ResNet stem
and k = 3 for conv1 of the SENet deep stem and the MobileNet stems; bf16 x
bf16 products summed in f32), the f32 bias is added, the activation
``act`` applied (``"relu"``, or ``"relu6"``, ``clip(y, 0, 6)``:
MobileNetV2) and the result quantized to int8 NHWC with ``clip(rint(y *
q), +-127)``. ``maxpool_i8`` is the 3x3/s2/pad-1 int8 max-pool (pad value -128) that follows it (the ResNet stem) or the
deep stem's int8 conv2 and conv3: a thread takes a channel vector of one
output column (16 bytes where C and the pointers allow) down a run of
output rows (:func:`maxpool_plan`). Both run ``csrc/stem.cu``.

The stem kernel runs on the bf16 tensor cores with K = 3 k k taps padded to
:func:`stem_k_layout`'s order; persistent blocks walk tiles of
:func:`stem_plan`'s output rows of one image.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ._build import (ACTS_I8, LAUNCHES, act_code_i8, activate_i8_reference,
                     check, device_of, library, no_tf32, require_cuda_or_cpu,
                     stream_of)

__all__ = ["stem_conv", "stem_conv_reference", "maxpool_i8",
           "maxpool_i8_reference", "maxpool_plan", "maxpool_info",
           "stem_plan", "stem_smem", "stem_k_layout", "kernel_info"]

_MAX_COUT = 64
_KSIZES = (3, 7)
_SMS = 132                     # the H100's SMs
_SMEM_ONE = 232_448            # dynamic shared memory a block may hold
_SMEM_TWO = 233_472 // 2 - 1_024   # ... with two blocks an SM
_STAGE_PITCH = _MAX_COUT + 16  # bytes a pixel of a warp's output staging
# A tile's time beside its 32-pixel rounds of 8 warps: the window's wait
# and the barriers, in rounds (an estimate).
_TILE_ROUNDS = 0.5
# maxpool_i8's output rows a thread: each shares its last input row with the
# next. Runs of 1-8 rows took 0.052-0.058 ms at ResNet-50's map and 0.031-
# 0.039 at DANet's, 16 more (kernels/dwconv_plans.py); 2 was the fastest
# 16-byte run at both.
_POOL_RUN = 2


@functools.lru_cache(maxsize=None)
def stem_k_layout(k: int) -> Tuple[Tuple[int, int, int], ...]:
    """The kernel's K order: entry i is the (plane, kernel row, kernel
    column) of K index i, or None for a zero weight. 3 k rows of SP = 8
    (k 7) or 4 (k 3) taps, tap 0 one column left of the kernel (weight 0),
    then zeros to a multiple of 16 (176 or 48 in all)."""
    sp = 8 if k == 7 else 4
    layout = []
    for row in range(3 * k):
        for t in range(sp):
            s = t - 1
            layout.append((row // k, row % k, s) if 0 <= s < k else None)
    return tuple(layout + [None] * (-len(layout) % 16))


def _window_pitch(w: int) -> int:
    return (w + 16 + 7) // 8 * 8


def stem_smem(k: int, rows: int, w: int) -> int:
    """Dynamic shared bytes of a block (``stem_smem`` in ``csrc/stem.cu``):
    the padded kernel ([64][K] bf16, rows padded by 16 bytes), the bias,
    the K pairs' window offsets, 8 warps' output staging (32 pixels of 80
    bytes) and two windows of 3 x (2 rows + k - 2) input rows."""
    kp = len(stem_k_layout(k))
    koff = -(-(kp // 2 * 4) // 16) * 16
    fixed = _MAX_COUT * (2 * kp + 16) + 4 * _MAX_COUT + koff + \
        8 * 32 * _STAGE_PITCH
    return fixed + 2 * 3 * (2 * rows + k - 2) * _window_pitch(w) * 2


def _stem_cost(b: int, ho: int, wo: int, rows: int, smem: int) -> float:
    """A call's time in 32-pixel rounds of a block's 8 warps: the tiles a
    persistent block walks (the grid is min(tiles, 2 x 132)) in waves of
    the blocks that fit at once, each tile its rounds plus
    ``_TILE_ROUNDS``."""
    tiles = b * -(-ho // rows)
    grid = min(tiles, 2 * _SMS)
    slots = _SMS * (2 if smem <= _SMEM_TWO else 1)
    rounds = -(-(-(-min(rows, ho) * wo // 32)) // 8)
    return -(-grid // slots) * -(-tiles // grid) * (rounds + _TILE_ROUNDS)


@functools.lru_cache(maxsize=256)
def stem_plan(b: int, h: int, w: int, k: int) -> int:
    """Output rows a tile for the k x k stem on ``b`` images of ``h`` x
    ``w``: of 1 .. 32 rows whose shared memory fits a block, the least
    :func:`_stem_cost`, and of those the most rows (the fewest halo rows
    read twice). Raises where one row's window does not fit. Cached: the
    wrapper asks once a call."""
    ho = (h + 2 * (k // 2) - k) // 2 + 1
    wo = (w + 2 * (k // 2) - k) // 2 + 1
    fit = [r for r in range(1, min(ho, 32) + 1)
           if stem_smem(k, r, w) <= _SMEM_ONE]
    if not fit:
        raise ValueError(f"stem: an image {w} wide leaves no room for one "
                         f"row's window in shared memory")
    return min(fit, key=lambda r: (_stem_cost(b, ho, wo, r,
                                              stem_smem(k, r, w)), -r))


def maxpool_i8_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pool, in f32: every window holds at
    least one pixel, so -inf padding gives what pad value -128 gives."""
    p = F.max_pool2d(x.permute(0, 3, 1, 2).to(torch.float32), 3, 2, 1)
    return p.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def stem_conv_reference(x: torch.Tensor, kf: torch.Tensor,
                        bias: torch.Tensor, q: float,
                        act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of K3: an f32 conv (exact products, no TF32)
    and the same epilogue."""
    w = kf.permute(3, 0, 1, 2).to(torch.float32)
    with no_tf32():
        y = F.conv2d(x.to(torch.float32), w, stride=2,
                     padding=kf.shape[1] // 2)
    y = activate_i8_reference(y + bias[None, :, None, None], act)
    yq = torch.clamp(torch.round(y * q), -127.0, 127.0).to(torch.int8)
    return yq.permute(0, 2, 3, 1).contiguous()


def stem_conv(x: torch.Tensor, kf: torch.Tensor, bias: torch.Tensor,
              q: float, act: str = "relu") -> torch.Tensor:
    """K3: ``x`` bf16 (B, 3, H, W); ``kf`` bf16 (3, k, k, Cout) with k in
    (3, 7), the folded kernel with input channel first; ``bias`` f32
    (Cout,); ``q`` the f32 quant factor; ``act`` one of ``ACTS_I8``.
    Returns int8 NHWC. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    act_code_i8("stem", act)
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"stem: x must be bf16 (B,3,H,W), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if kf.dtype != torch.bfloat16 or kf.dim() != 4 or kf.shape[0] != 3 or \
            kf.shape[1] != kf.shape[2] or kf.shape[1] not in _KSIZES:
        raise ValueError(f"stem: kf must be bf16 (3,k,k,Cout) with k in "
                         f"{_KSIZES}, got {kf.dtype} {tuple(kf.shape)}")
    k, cout = kf.shape[1], kf.shape[3]
    if cout % 8 != 0 or cout > _MAX_COUT:
        raise ValueError(f"stem: Cout={cout} must be a multiple of 8, "
                         f"at most {_MAX_COUT}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (cout,):
        raise ValueError(f"stem: bias must be f32 ({cout},)")
    if not require_cuda_or_cpu("stem", x, kf, bias):
        return stem_conv_reference(x, kf, bias, q, act)
    if not all(t.is_contiguous() for t in (x, kf, bias)):
        raise ValueError("stem: inputs must be contiguous")
    bsz, _, h, w = x.shape
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
    if x.numel() >= 2 ** 31 or bsz * ho * wo * cout >= 2 ** 40:
        raise ValueError(f"stem: x {tuple(x.shape)} exceeds the kernel's "
                         f"indexing")
    return _launch(x, kf, bias, q, stem_plan(bsz, h, w, k), act)


def _launch(x, kf, bias, q, rows, act="relu"):
    """K3 on the card in tiles of ``rows`` output rows (checked operands;
    :func:`stem_plan`'s rows, or others for the plans tool)."""
    bsz, _, h, w = x.shape
    k, cout = kf.shape[1], kf.shape[3]
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        check(library().pcv_stem(x.data_ptr(), kf.data_ptr(), bias.data_ptr(),
                                 float(q), ACTS_I8[act], k,
                                 out.data_ptr(), bsz, h, w, ho, wo, cout,
                                 rows, stream_of(x)), "stem")
    LAUNCHES["stem"] += 1
    return out


@functools.lru_cache(maxsize=256)
def maxpool_plan(b: int, h: int, w: int, c: int,
                 align: int) -> Tuple[int, int]:
    """(bytes a vector, output rows a thread) of ``maxpool_i8`` on
    (b, h, w, c) whose pointers are both ``align``-byte aligned: the widest
    of 16, 8, 4, 1 bytes that divides C and ``align``, and runs of
    ``_POOL_RUN`` output rows. Cached per shape."""
    vb = next(v for v in (16, 8, 4, 1) if c % v == 0 and align % v == 0)
    return vb, min(_POOL_RUN, (h - 1) // 2 + 1)


def maxpool_i8(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2/pad-1 max-pool of an int8 NHWC map, pad value -128 (JAX
    ``quant/resnet_int8.py:_maxpool_i8``). CUDA tensors run the kernel
    under :func:`maxpool_plan`, CPU tensors the plain version."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"maxpool_i8: x must be int8 NHWC, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not require_cuda_or_cpu("maxpool_i8", x):
        return maxpool_i8_reference(x)
    if not x.is_contiguous():
        raise ValueError("maxpool_i8: x must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"maxpool_i8: x {tuple(x.shape)} exceeds the "
                         f"kernel's 32-bit indexing")
    bsz, h, w, c = x.shape
    out = torch.empty((bsz, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c),
                      dtype=torch.int8, device=x.device)
    align = (x.data_ptr() | out.data_ptr() | 16) & -(x.data_ptr()
                                                      | out.data_ptr() | 16)
    return _pool_launch(x, out, *maxpool_plan(bsz, h, w, c, align))


def _pool_launch(x, out, vb, run):
    """``maxpool_i8`` on the card in ``vb``-byte vectors, ``run`` output
    rows a thread (checked operands; the plan's, or others for the plans
    tool and the card tests)."""
    bsz, h, w, c = x.shape
    with device_of(x):
        check(library().pcv_maxpool_i8(x.data_ptr(), out.data_ptr(), bsz, h,
                                       w, out.shape[1], out.shape[2], c, vb,
                                       run, stream_of(x)), "maxpool_i8")
    LAUNCHES["maxpool_i8"] += 1
    return out


def maxpool_info(vb: int) -> dict:
    """Registers a thread and spilled (local) bytes of the pool's
    ``vb``-byte instance (needs the card)."""
    out = (ctypes.c_int * 2)()
    check(library().pcv_maxpool_i8_info(vb, out), "maxpool_i8 info")
    return dict(zip(("registers", "spill_bytes"), out), vb=vb)


def kernel_info(b: int, h: int, w: int, k: int) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of the stem instance that ``b`` images of ``h`` x ``w``
    under a k x k kernel launch (16-byte window copies where w % 8 == 0),
    with the plan's rows a tile (needs the card)."""
    rows = stem_plan(b, h, w, k)
    out = (ctypes.c_int * 4)()
    check(library().pcv_stem_info(k, int(w % 8 == 0), rows, w, out),
          "stem info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out), rows=rows)
