"""The int8-input 7x7 / stride-2 stem (K9), the counterpart of
``pytorchcv_tpu.kernels.stem_conv``.

``stem_conv7x7_s2(x, k7, gain, bias, s_img, s_out)``: the f32 image ``x``
(B, H, W, 3) is quantized at amax ``s_img``, convolved (pad 3) with the f32
kernel ``k7`` (7, 7, 3, O) quantized per output channel, then the folded
per-channel affine ``gain``/``bias``, ReLU and the int8 requantization at
``s_out`` give (B, H/2, W/2, O) int8. As in the JAX package no serving
route calls it (it changes the stem's quantization; the routes run K3's
bf16 stem): the function is its entry point. The kernel is
``csrc/stem_int8.cu``; on CPU tensors the plain version runs.

The kernel runs on the int8 tensor cores with K in :func:`stem_k_layout`'s
order; persistent blocks walk tiles of :func:`stem_int8_plan`'s output rows
of one image. ``stem_conv7x7_s2`` quantizes the weights it is given on every
call, as the JAX function does; a caller that keeps the weights fixed
prepares them once with :func:`prepare_stem` and calls
:func:`stem_conv7x7_s2_prepared`.

Contract: 3 channels, even H and W, O a multiple of 8 and at most 64. The
JAX function's ``wout % 16`` was a TPU layout limit; K9 does not have it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ._build import (LAUNCHES, autograd_records, check, device_of, f32,
                     library, require_cuda_or_cpu, stream_of)
from .int8_conv import int8_conv_reference

__all__ = ["prepare_stem", "stem_conv7x7_s2", "stem_conv7x7_s2_prepared",
           "stem_conv7x7_s2_reference", "stem_k_layout", "stem_int8_plan",
           "stem_int8_smem", "kernel_info"]

_MAX_COUT = 64
_SMS = 132                     # the H100's SMs
_SMEM_TWO = 233_472 // 2 - 1_024   # dynamic shared memory a block, two an SM
# csrc/stem_int8.cu's fixed shared bytes: the [64][224 + 16] int8 kernel,
# the f32 gain and bias, 8 warps' output staging (32 pixels of 80 bytes).
_FIXED_SMEM = 64 * 240 + 2 * 64 * 4 + 8 * 32 * 80
# A window word's load and quantization, in 32-pixel rounds of a block's
# 8 warps (an estimate: three f32 reads and four roundings a thread-word
# against 7 k32 steps of 16 mma a warp-round).
_WORD_ROUNDS = 1.0 / 8


@functools.lru_cache(maxsize=None)
def stem_k_layout() -> Tuple[Tuple[int, int, int], ...]:
    """The kernel's K order: entry k is the (kernel row r, kernel column s,
    channel c) of K index k, or None for a zero weight. k = (r * 8 + s) * 4
    + c with s padded 7 -> 8 and c 3 -> 4: 224 in all, one 32-byte mma
    step a kernel row, one 32-bit A word an input pixel."""
    return tuple((k >> 5, (k >> 2) & 7, k & 3)
                 if (k >> 2) & 7 < 7 and k & 3 < 3 else None
                 for k in range(7 * 8 * 4))


def window_geometry(rows: int, wo: int) -> Tuple[int, int, int]:
    """(input rows, words a plane row, the odd plane's first word) of a
    tile's window in ``csrc/stem_int8.cu``: 2 rows + 5 input rows, each
    as even and odd columns (one word a pixel) in planes of wo + 3 words;
    the odd plane starts at a word = 16 mod 32 (bank 16)."""
    rows_in, hp = 2 * rows + 5, wo + 3
    return rows_in, hp, (rows_in * hp + 15) // 32 * 32 + 16


def stem_int8_smem(rows: int, wo: int) -> int:
    """Dynamic shared bytes of a block at ``rows`` output rows a tile of a
    map ``wo`` wide (``stem_int8_smem`` in ``csrc/stem_int8.cu``)."""
    rows_in, hp, po = window_geometry(rows, wo)
    return _FIXED_SMEM + 4 * (po + rows_in * hp)


def _plan_cost(b: int, ho: int, wo: int, rows: int) -> float:
    """A call's time in 32-pixel rounds of a block's 8 warps: the tiles
    each persistent block walks (the grid is min(tiles, 2 x 132), two
    blocks an SM), each its rounds plus its window's words a thread."""
    tiles = b * -(-ho // rows)
    grid = min(tiles, 2 * _SMS)
    rounds = -(-(-(-min(rows, ho) * wo // 32)) // 8)
    rows_in, hp, _ = window_geometry(rows, wo)
    return -(-tiles // grid) * (rounds + _WORD_ROUNDS * rows_in * 2 * hp
                                / 256)


@functools.lru_cache(maxsize=256)
def stem_int8_plan(b: int, h: int, w: int) -> int:
    """Output rows a tile for ``b`` images of ``h`` x ``w``: of 1 .. 32
    rows whose shared memory lets two blocks share an SM, the least
    :func:`_plan_cost`, and of those the most rows. Raises where one row's
    window does not fit. Cached: the wrapper asks once a call."""
    ho, wo = h // 2, w // 2
    fit = [r for r in range(1, min(ho, 32) + 1)
           if stem_int8_smem(r, wo) <= _SMEM_TWO]
    if not fit:
        raise ValueError(f"stem_int8: an image {w} wide leaves no room for "
                         f"one row's window in shared memory")
    return min(fit, key=lambda r: (_plan_cost(b, ho, wo, r), -r))


def prepare_stem(k7: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
                 s_img: float, s_out: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(s_w, wq, g)`` as the JAX ``prepare_stem`` computes them in numpy
    f32: ``s_w = max(max|k|, 1e-12) / 127`` per output channel, ``wq =
    clip(round_half_even(k / s_w), +-127)`` int8 (7, 7, 3, O) and ``g =
    (gain * s_w) * f32(s_img / 127)``. ``bias`` and ``s_out`` enter the
    epilogue unchanged."""
    k = k7.detach().to(torch.float32)
    s_w = torch.clamp_min(k.abs().amax(dim=(0, 1, 2)), 1e-12) / 127.0
    wq = torch.clamp(torch.round(k / s_w), -127, 127).to(torch.int8)
    g = (gain.detach().to(torch.float32) * s_w) * f32(s_img / 127.0)
    return s_w, wq, g


def _check(x, k7, gain, bias) -> int:
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[3] != 3 or \
            x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"stem_int8: x must be f32 (B, H, W, 3) with even H "
                         f"and W, got {x.dtype} {tuple(x.shape)}")
    if k7.dim() != 4 or tuple(k7.shape[:3]) != (7, 7, 3):
        raise ValueError(f"stem_int8: k7 must be (7, 7, 3, O), got "
                         f"{tuple(k7.shape)}")
    o = k7.shape[3]
    if o % 8 or o > _MAX_COUT:
        raise ValueError(f"stem_int8: O={o} must be a multiple of 8, at most "
                         f"{_MAX_COUT}")
    for name, v in (("gain", gain), ("bias", bias)):
        if v.dtype != torch.float32 or tuple(v.shape) != (o,):
            raise ValueError(f"stem_int8: {name} must be f32 ({o},)")
    return o


def stem_conv7x7_s2_reference(x: torch.Tensor, k7: torch.Tensor,
                              gain: torch.Tensor, bias: torch.Tensor,
                              s_img: float, s_out: float) -> torch.Tensor:
    """Plain PyTorch version of K9: the weights prepared, the image
    quantized in f32, then K2's plain int8 conv (exact float64 sums) with
    the same epilogue."""
    _, wq, g = prepare_stem(k7, gain, bias, s_img, s_out)
    return _prepared_reference(x, wq, g, bias, s_img, s_out)


def _prepared_reference(x, wq, g, bias, s_img, s_out):
    xq = torch.clamp(torch.round(x.to(torch.float32) * f32(127.0 / s_img)),
                     -127, 127).to(torch.int8)
    return int8_conv_reference(xq, wq.permute(3, 0, 1, 2), g,
                               bias.to(torch.float32), stride=2, act="relu",
                               q=f32(127.0 / s_out))


def stem_conv7x7_s2(x: torch.Tensor, k7: torch.Tensor, gain: torch.Tensor,
                    bias: torch.Tensor, s_img: float,
                    s_out: float) -> torch.Tensor:
    """K9: ``x`` f32 (B, H, W, 3), ``k7`` (7, 7, 3, O), ``gain``/``bias``
    f32 (O,) -> int8 (B, H/2, W/2, O) at amax ``s_out``. The weights are
    quantized on every call (:func:`prepare_stem`). CUDA tensors run the
    kernel, CPU tensors the plain version; anything else raises, a call
    that autograd would record included."""
    _check(x, k7, gain, bias)
    if autograd_records(x, k7, gain, bias):
        raise ValueError("stem_int8: K9 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("stem_int8", x, k7, gain, bias):
        return stem_conv7x7_s2_reference(x, k7, gain, bias, s_img, s_out)
    _, wq, g = prepare_stem(k7, gain, bias, s_img, s_out)
    return stem_conv7x7_s2_prepared(x, wq, g, bias, s_img, s_out)


def stem_conv7x7_s2_prepared(x: torch.Tensor, wq: torch.Tensor,
                             g: torch.Tensor, bias: torch.Tensor,
                             s_img: float, s_out: float) -> torch.Tensor:
    """K9 on weights prepared once by :func:`prepare_stem`: ``wq`` int8
    (7, 7, 3, O), ``g`` f32 (O,) its gain, for a caller that keeps the
    weights fixed. The same result as :func:`stem_conv7x7_s2` on the
    weights ``wq`` and ``g`` came from; the same contract otherwise."""
    if wq.dtype != torch.int8:
        raise ValueError(f"stem_int8: wq must be int8, got {wq.dtype}")
    o = _check(x, wq, g, bias)
    if autograd_records(x, g, bias):
        raise ValueError("stem_int8: K9 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("stem_int8", x, wq, g, bias):
        return _prepared_reference(x, wq, g, bias, s_img, s_out)
    if not all(t.is_contiguous() for t in (x, wq, g, bias)):
        raise ValueError("stem_int8: x, wq, g and bias must be contiguous")
    bsz, h, w, _ = x.shape
    if x.numel() >= 2 ** 31 or bsz * (h // 2) * (w // 2) * o >= 2 ** 31:
        raise ValueError(f"stem_int8: x {tuple(x.shape)} exceeds the kernel's "
                         f"indexing")
    return _launch(x, wq, g, bias, s_img, s_out, stem_int8_plan(bsz, h, w))


def _launch(x, wq, g, bias, s_img, s_out, rows):
    """K9 on the card in tiles of ``rows`` output rows (checked operands;
    :func:`stem_int8_plan`'s rows, or others for the plans tool)."""
    bsz, h, w, _ = x.shape
    o = wq.shape[3]
    out = torch.empty((bsz, h // 2, w // 2, o), dtype=torch.int8,
                      device=x.device)
    with device_of(x):
        check(library().pcv_stem_int8(
            x.data_ptr(), wq.data_ptr(), g.data_ptr(), bias.data_ptr(),
            f32(127.0 / s_img), f32(127.0 / s_out), out.data_ptr(), bsz, h, w,
            h // 2, w // 2, o, rows, stream_of(x)), "stem_int8")
    LAUNCHES["stem_int8"] += 1
    return out


def kernel_info(b: int, h: int, w: int) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of K9 on ``b`` images of ``h`` x ``w`` (16-byte image
    reads where w % 4 == 0), with the plan's rows a tile (needs the
    card)."""
    rows = stem_int8_plan(b, h, w)
    out = (ctypes.c_int * 4)()
    check(library().pcv_stem_int8_info(rows, w // 2, int(w % 4 == 0), out),
          "stem_int8 info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out), rows=rows)
