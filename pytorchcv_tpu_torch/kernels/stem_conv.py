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

Contract: 3 channels, even H and W, O a multiple of 8 and at most 64. The
JAX function's ``wout % 16`` was a TPU layout limit; K9 does not have it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._build import (LAUNCHES, autograd_records, check, f32, library,
                     require_cuda_or_cpu, stream_of)
from .int8_conv import int8_conv_reference

__all__ = ["prepare_stem", "stem_conv7x7_s2", "stem_conv7x7_s2_reference"]

_MAX_COUT = 64


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
    """Plain PyTorch version of K9: the image quantized in f32, then K2's
    plain int8 conv (exact float64 sums) with the same epilogue."""
    _, wq, g = prepare_stem(k7, gain, bias, s_img, s_out)
    xq = torch.clamp(torch.round(x.to(torch.float32) * f32(127.0 / s_img)),
                     -127, 127).to(torch.int8)
    return int8_conv_reference(xq, wq.permute(3, 0, 1, 2), g,
                               bias.to(torch.float32), stride=2, relu=True,
                               q=f32(127.0 / s_out))


def stem_conv7x7_s2(x: torch.Tensor, k7: torch.Tensor, gain: torch.Tensor,
                    bias: torch.Tensor, s_img: float,
                    s_out: float) -> torch.Tensor:
    """K9: ``x`` f32 (B, H, W, 3), ``k7`` (7, 7, 3, O), ``gain``/``bias``
    f32 (O,) -> int8 (B, H/2, W/2, O) at amax ``s_out``. CUDA tensors run
    the kernel, CPU tensors the plain version; anything else raises, a call
    that autograd would record included."""
    o = _check(x, k7, gain, bias)
    if autograd_records(x, k7, gain, bias):
        raise ValueError("stem_int8: K9 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("stem_int8", x, k7, gain, bias):
        return stem_conv7x7_s2_reference(x, k7, gain, bias, s_img, s_out)
    if not x.is_contiguous() or not bias.is_contiguous():
        raise ValueError("stem_int8: x and bias must be contiguous")
    bsz, h, w, _ = x.shape
    if bsz > 65535 or h // 2 > 65535:
        raise ValueError(f"stem_int8: x {tuple(x.shape)} exceeds the grid")
    _, wq, g = prepare_stem(k7, gain, bias, s_img, s_out)
    wt = wq.permute(2, 0, 1, 3).contiguous()          # (3, 7, 7, O)
    g = g.contiguous()
    out = torch.empty((bsz, h // 2, w // 2, o), dtype=torch.int8,
                      device=x.device)
    with torch.cuda.device(x.device):
        check(library().pcv_stem_int8(
            x.data_ptr(), wt.data_ptr(), g.data_ptr(),
            bias.data_ptr(), f32(127.0 / s_img), f32(127.0 / s_out),
            out.data_ptr(), bsz, h, w, h // 2, w // 2, o, stream_of(x)),
            "stem_int8")
    LAUNCHES["stem_int8"] += 1
    return out
