"""Depthwise conv + folded BatchNorm + activation (K6): the block
``conv(groups=C) -> BN -> activation`` of the depthwise families in one
pass (``csrc/dwconv.cu``). Counterpart of ``pytorchcv_tpu.kernels.dwconv``
(``dwconv2d_bn_act``), in the port's NCHW layout.

The arithmetic, kernel and plain version alike: the k*k products summed in
f32, row ``di`` outer and column ``dj`` inner, each product and sum rounded
on its own; then ``acc * scale`` and ``+ shift`` (two roundings), the
activation in f32, one cast to x's type. f32 results of the two are
bit-exact for the piecewise-linear activations; sigmoid and swish differ
only by ``exp``'s ulps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ._build import (LAUNCHES, autograd_records, check, library,
                     require_cuda_or_cpu, stream_of)

__all__ = ["ACTIVATIONS", "dwconv2d_bn_act", "dwconv2d_bn_act_reference"]

_DTYPES = (torch.bfloat16, torch.float32)
_KSIZES = (3, 5, 7)
_THREADS = 128          # output pixels a block (csrc/dwconv.cu kThreads)


def _clip06(y):
    return y.clamp(0.0, 6.0)


# The activations of the TPU kernel (JAX ``kernels/dwconv.py:35-43``), in
# its order, which is also K6's code for each. ``hswish`` multiplies by
# 1/6 as there (the model's hswish divides by 6).
ACTIVATIONS = {
    "none": lambda y: y,
    "relu": lambda y: y.clamp_min(0.0),
    "relu6": _clip06,
    "hswish": lambda y: y * _clip06(y + 3.0) * (1.0 / 6.0),
    "hsigmoid": lambda y: _clip06(y + 3.0) * (1.0 / 6.0),
    "swish": lambda y: y * torch.sigmoid(y),
    "sigmoid": torch.sigmoid,
}
_ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}

Pad = Tuple[Tuple[int, int], Tuple[int, int]]


def _out_size(size: int, k: int, stride: int, lo: int, hi: int) -> int:
    return (size + lo + hi - k) // stride + 1


def dwconv2d_bn_act_reference(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor, shift: torch.Tensor,
                              stride: int, pad: Pad,
                              act: str) -> torch.Tensor:
    """Plain PyTorch version of K6, in its order: a loop over the taps on
    f32 tensors (not ``F.conv2d``), then the epilogue."""
    k = w.shape[-1]
    (top, bottom), (left, right) = pad
    _, c, h, wd = x.shape
    ho = _out_size(h, k, stride, top, bottom)
    wo = _out_size(wd, k, stride, left, right)
    xp = F.pad(x.to(torch.float32), (left, right, top, bottom))
    w_taps = w.to(torch.float32).reshape(c, k * k).t().reshape(
        k * k, 1, c, 1, 1)
    acc = None
    for t in range(k * k):
        di, dj = divmod(t, k)        # row outer, column inner
        prod = xp[:, :, di:di + stride * (ho - 1) + 1:stride,
                  dj:dj + stride * (wo - 1) + 1:stride] * w_taps[t]
        acc = prod if acc is None else acc + prod
    y = acc * scale.view(1, c, 1, 1) + shift.view(1, c, 1, 1)
    return ACTIVATIONS[act](y).to(x.dtype)


def dwconv2d_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, stride: int = 1,
                    pad: Pad = ((1, 1), (1, 1)),
                    act: str = "relu") -> torch.Tensor:
    """K6: ``x`` contiguous (N, C, H, W) f32 or bf16; ``w`` (C, 1, k, k) in
    x's type with k in (3, 5, 7), as the depthwise conv stores it;
    ``scale``, ``shift`` f32 (C,), the folded BN; ``stride`` 1 or 2;
    ``pad`` ((top, bottom), (left, right)) zeros; ``act`` one of
    :data:`ACTIVATIONS`. Returns (N, C, Ho, Wo) in x's type.

    Anything else raises, a call that autograd would record included (K6
    has no backward yet). CUDA tensors run the kernel, CPU tensors the
    plain version."""
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"dwconv: x must be contiguous (N, C, H, W) of "
                         f"{_DTYPES}, got {tuple(x.shape)} {x.dtype}"
                         f"{'' if x.is_contiguous() else ', not contiguous'}")
    n, c, h, wd = x.shape
    k = w.shape[-1] if w.dim() == 4 else None
    if (w.dim() != 4 or tuple(w.shape) != (c, 1, k, k) or k not in _KSIZES
            or w.dtype != x.dtype or not w.is_contiguous()):
        raise ValueError(f"dwconv: w must be contiguous ({c}, 1, k, k) in "
                         f"{x.dtype} with k in {_KSIZES}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) or \
                not v.is_contiguous():
            raise ValueError(f"dwconv: {name} must be contiguous f32 "
                             f"({c},), got {tuple(v.shape)} {v.dtype}")
    if stride not in (1, 2):
        raise ValueError(f"dwconv: stride must be 1 or 2, got {stride}")
    (top, bottom), (left, right) = pad
    if min(top, bottom, left, right) < 0:
        raise ValueError(f"dwconv: negative padding {pad}")
    if act not in ACTIVATIONS:
        raise ValueError(f"dwconv: act must be one of {list(ACTIVATIONS)}, "
                         f"got {act!r}")
    ho = _out_size(h, k, stride, top, bottom)
    wo = _out_size(wd, k, stride, left, right)
    if ho < 1 or wo < 1:
        raise ValueError(f"dwconv: empty output for x {tuple(x.shape)}, "
                         f"k {k}, stride {stride}, pad {pad}")
    if autograd_records(x, w, scale, shift):
        raise ValueError("dwconv: K6 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("dwconv", x, w, scale, shift):
        return dwconv2d_bn_act_reference(x, w, scale, shift, stride, pad,
                                         act)
    if max(x.numel(), n * c * ho * wo) >= 2 ** 31 or \
            -(-ho * wo // _THREADS) > 65535:
        raise ValueError(f"dwconv: x {tuple(x.shape)} or its output "
                         f"exceeds the kernel's index range")
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        check(lib.pcv_dwconv(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), n, c, h, wd, ho, wo, k, stride, top, left,
            _ACT_CODES[act], int(x.dtype == torch.bfloat16), stream_of(x)),
            "dwconv")
    LAUNCHES["dwconv"] += 1
    return out
