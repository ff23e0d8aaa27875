"""int8 NHWC depthwise 3x3 convolution with the int8 routes' epilogue
(K12, ``csrc/dwconv_i8.cu``): the depthwise conv of the int8 MobileNet v1
and v2 pipelines (JAX ``quant/mobilenet_int8.py``, ``_conv_i8`` with
``feature_group_count = C`` and ``_cell6`` / ``cell_relu``).

One call: ``x`` int8 (B, H, W, C) convolved per channel with ``w`` int8
(3, 3, C) (JAX's HWIO kernel with I = 1), stride 1 or 2, pad 1; the exact
int32 sums ``acc`` (9 * 127**2 < 2**24), then ``y = f32(acc) * A + B``
(two roundings), the activation ``act`` (``"relu"``, ``max(y, 0)``;
``"relu6"``, ``clip(y, 0, 6)``; or None), and ``clip(rint(y * q), +-127)``
as int8. The kernel and the plain version are
bit-exact against the JAX cell.

The kernel walks maxpool_i8's plan: a thread takes a channel vector of
:func:`dwconv_i8_plan`'s width (16 bytes where C and the pointers allow;
8, 4 or 1 below) of one output column down a run of output rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ._build import (ACTS_I8, LAUNCHES, act_code_i8, activate_i8_reference,
                     check, device_of, library, require_cuda_or_cpu,
                     stream_of)

__all__ = ["dwconv_i8", "dwconv_i8_reference", "dwconv_i8_plan",
           "kernel_info"]

# Output rows a thread (maxpool_i8's run, kernels/stem.py:_POOL_RUN).
_RUN = 2


def _out_size(size: int, stride: int) -> int:
    return (size - 1) // stride + 1


@functools.lru_cache(maxsize=1024)
def dwconv_i8_plan(b: int, h: int, w: int, c: int, stride: int,
                   align: int) -> Tuple[int, int]:
    """(bytes a vector, output rows a thread) of K12 on x (b, h, w, c) at
    ``stride``, whose pointers are all ``align``-byte aligned: the widest of
    16, 8, 4, 1 bytes that divides C and ``align``, and runs of ``_RUN``
    output rows. Cached per shape."""
    vb = next(v for v in (16, 8, 4, 1) if c % v == 0 and align % v == 0)
    return vb, min(_RUN, _out_size(h, stride))


def dwconv_i8_reference(x: torch.Tensor, w: torch.Tensor,
                        gain_a: torch.Tensor, bias_b: torch.Tensor, q: float,
                        stride: int = 1, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of K12: the conv in float64 (exact), then the
    epilogue in float32, as K2's plain version."""
    c = x.shape[-1]
    acc = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                   w.permute(2, 0, 1).unsqueeze(1).to(torch.float64),
                   stride=stride, padding=1, groups=c)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1)
    y = activate_i8_reference(acc.to(torch.float32) * gain_a + bias_b, act)
    return torch.clamp(torch.round(y * q), -127.0, 127.0).to(
        torch.int8).contiguous()


def dwconv_i8(x: torch.Tensor, w: torch.Tensor, gain_a: torch.Tensor,
              bias_b: torch.Tensor, q: float, stride: int = 1,
              act: str = "relu") -> torch.Tensor:
    """K12: ``x`` contiguous int8 (B, H, W, C), ``w`` contiguous int8 (3, 3,
    C), ``gain_a``/``bias_b`` f32 (C,), ``q`` the f32 quant factor,
    ``stride`` 1 or 2, ``act`` one of ``ACTS_I8``. Returns int8 (B, Ho, Wo,
    C). CUDA tensors run the kernel under :func:`dwconv_i8_plan`, CPU
    tensors the plain version."""
    act_code_i8("dwconv_i8", act)
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"dwconv_i8: x must be int8 NHWC, got {x.dtype} "
                         f"{tuple(x.shape)}")
    bsz, h, wd, c = x.shape
    if w.dtype != torch.int8 or tuple(w.shape) != (3, 3, c):
        raise ValueError(f"dwconv_i8: w must be int8 (3, 3, {c}), got "
                         f"{w.dtype} {tuple(w.shape)}")
    for v in (gain_a, bias_b):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"dwconv_i8: gain/bias must be f32 ({c},)")
    if stride not in (1, 2):
        raise ValueError(f"dwconv_i8: stride must be 1 or 2, got {stride}")
    if not require_cuda_or_cpu("dwconv_i8", x, w, gain_a, bias_b):
        return dwconv_i8_reference(x, w, gain_a, bias_b, q, stride, act)
    if not all(t.is_contiguous() for t in (x, w, gain_a, bias_b)):
        raise ValueError("dwconv_i8: inputs must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"dwconv_i8: x {tuple(x.shape)} exceeds the "
                         f"kernel's 32-bit indexing")
    out = torch.empty((bsz, _out_size(h, stride), _out_size(wd, stride), c),
                      dtype=torch.int8, device=x.device)
    ptrs = x.data_ptr() | w.data_ptr() | out.data_ptr() | 16
    return _launch(x, w, gain_a, bias_b, q, stride, act, out,
                   *dwconv_i8_plan(bsz, h, wd, c, stride, ptrs & -ptrs))


def _launch(x, w, gain_a, bias_b, q, stride, act, out, vb, run):
    """K12 on the card in ``vb``-byte vectors, ``run`` output rows a thread
    (checked operands; the plan's, or others for the card tests)."""
    bsz, h, wd, c = x.shape
    with device_of(x):
        check(library().pcv_dwconv_i8(
            x.data_ptr(), w.data_ptr(), gain_a.data_ptr(), bias_b.data_ptr(),
            float(q), ACTS_I8[act], out.data_ptr(), bsz, h, wd,
            out.shape[1], out.shape[2], c, stride, vb, run, stream_of(x)),
            "dwconv_i8")
    LAUNCHES["dwconv_i8"] += 1
    return out


def kernel_info(vb: int) -> dict:
    """Registers a thread and spilled (local) bytes of K12's ``vb``-byte
    instance (needs the card)."""
    out = (ctypes.c_int * 2)()
    check(library().pcv_dwconv_i8_info(vb, out), "dwconv_i8 info")
    return dict(zip(("registers", "spill_bytes"), out), vb=vb)
