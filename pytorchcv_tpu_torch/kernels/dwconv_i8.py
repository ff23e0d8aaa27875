"""int8 NHWC depthwise 3x3 convolution with the int8 routes' epilogue
(K12, ``csrc/dwconv_i8.cu``): the depthwise conv of the int8 MobileNet v1
and v2 pipelines (JAX ``quant/mobilenet_int8.py``, ``_conv_i8`` with
``feature_group_count = C`` and ``_cell6`` / ``cell_relu``).

One call: ``x`` int8 (B, H, W, C) convolved per channel with ``w`` int8
(3, 3, C) (JAX's HWIO kernel with I = 1), stride 1 or 2, pad 1; the exact
int32 sums ``acc`` (9 * 127**2 < 2**24), then ``y = f32(acc) * A + B``
(two roundings), the activation ``act`` (``"relu"``, ``max(y, 0)``;
``"relu6"``, ``clip(y, 0, 6)``; or None), and ``clip(rint(y * q), +-127)``
as int8, for a finite ``q``. The kernel and the plain version are
bit-exact against the JAX cell.

The kernel's walk (:func:`dwconv_i8_plan`, cached per shape): a thread
takes ``cpt`` channels (a 32-bit word of 4 where C and the pointers allow,
else 1) of a strip of ``STRIP`` output columns down a band of ``rows``
output rows, keeping the last 3 input rows of its strip in registers,
channel major; a kernel row of a channel is one ``__dp4a`` of its 3-column
window with the weight word (w0, w1, w2, 0); the activation folds into the
final clip, whose bounds go by the sign of q. :func:`call_shapes` lists
the calls of a MobileNet's int8 forward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ._build import (ACTS_I8, LAUNCHES, act_code_i8, activate_i8_reference,
                     check, device_of, library, require_cuda_or_cpu,
                     stream_of)

__all__ = ["dwconv_i8", "dwconv_i8_reference", "dwconv_i8_plan",
           "K12Plan", "INSTANCES", "STRIP", "call_shapes", "kernel_info"]

# The kernel's instances: (channels a thread, stride).
INSTANCES = ((4, 1), (4, 2), (1, 1), (1, 2))
# Output columns a strip, the kernel's kV (strips of 8 and 16 columns were
# no faster at the MobileNet calls, PERF.md, K12 row).
STRIP = 4
# The plan's most rows a thread at stride 1 and 2, and the threads it
# keeps at least (rows are cut further to reach them).
_ROWS = {1: 28, 2: 8}
_MIN_THREADS = 132 * 256


class K12Plan(NamedTuple):
    cpt: int        # channels a thread: 4 (one 32-bit word) or 1
    rows: int       # output rows a thread


def _out_size(size: int, stride: int) -> int:
    return (size - 1) // stride + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def dwconv_i8_plan(b: int, h: int, w: int, c: int, stride: int,
                   align: int) -> K12Plan:
    """K12's walk of x (b, h, w, c) at ``stride``, whose pointers are all
    ``align``-byte aligned: 4 channels a thread where C and ``align``
    allow (else 1), strips of ``STRIP`` output columns, and balanced bands
    of at most 28 output rows a thread at stride 1 (8 at stride 2), fewer
    where that leaves under ``_MIN_THREADS`` threads (one row at least):
    near the fastest at every MobileNet call of the card's sweep
    (``dwconv_i8_parts plans``). Cached per shape."""
    cpt = 4 if c % 4 == 0 and align % 4 == 0 else 1
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    per_band = b * _cdiv(wo, STRIP) * (c // cpt)
    bands = min(ho, max(_cdiv(ho, _ROWS[stride]),
                        _cdiv(_MIN_THREADS, per_band)))
    return K12Plan(cpt, _cdiv(ho, bands))


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
    C), ``gain_a``/``bias_b`` f32 (C,), ``q`` the f32 quant factor (finite
    as f32), ``stride`` 1 or 2, ``act`` None, ``"relu"`` or ``"relu6"``.
    Returns int8 (B, Ho, Wo, C). CUDA tensors run the kernel under
    :func:`dwconv_i8_plan`, CPU tensors the plain version."""
    act_code_i8("dwconv_i8", act, (None, "relu", "relu6"))
    if not math.isfinite(ctypes.c_float(q).value):
        raise ValueError(f"dwconv_i8: q must be finite as f32, got {q}")
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
                   dwconv_i8_plan(bsz, h, wd, c, stride, ptrs & -ptrs))


def _launch(x, w, gain_a, bias_b, q, stride, act, out, plan: K12Plan):
    """K12 on the card under ``plan`` (checked operands; the plan's, or
    others for the card tests and the plans tool)."""
    bsz, h, wd, c = x.shape
    with device_of(x):
        check(library().pcv_dwconv_i8(
            x.data_ptr(), w.data_ptr(), gain_a.data_ptr(), bias_b.data_ptr(),
            float(q), ACTS_I8[act], out.data_ptr(), bsz, h, wd,
            out.shape[1], out.shape[2], c, stride, *plan, stream_of(x)),
            "dwconv_i8")
    LAUNCHES["dwconv_i8"] += 1
    return out


def kernel_info(cpt: int, stride: int) -> dict:
    """Registers a thread and spilled (local) bytes of K12's instance
    (``cpt``, ``stride``) (needs the card)."""
    out = (ctypes.c_int * 2)()
    check(library().pcv_dwconv_i8_info(cpt, stride, out), "dwconv_i8 info")
    return dict(zip(("registers", "spill_bytes"), out), cpt=cpt,
                stride=stride)


def call_shapes(name: str, size: int = 224, batch: int = 1
                ) -> List[Tuple[Tuple[int, int, int, int], int, str]]:
    """((B, H, W, C) of x, stride, act) of each K12 call of one forward of
    the int8 MobileNet ``name`` (a v1 or v2 name of the int8 routes) at
    ``size`` x ``size``, in order: the pipeline's prepare and forward run
    under ``FakeTensorMode`` (shapes only) with every scale 1."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models import get_constructor
    from ..quant import mobilenet_int8 as mq
    calls = []
    orig = mq.dwconv_i8

    def record(x, w, a, b, q, stride, act):
        calls.append((tuple(x.shape), stride, act))
        return orig(x, w, a, b, q, stride, act)
    mq.dwconv_i8 = record
    try:
        with FakeTensorMode():
            model = get_constructor(name)().eval()
            prep = mq.prepare_int8_mobilenet_v1 if \
                mq.is_mobilenet_v1_tree(model) else mq.prepare_int8_mobilenet
            scales = {n.replace(".", "/"): 1.0
                      for n, m in model.named_modules()
                      if isinstance(m, torch.nn.Conv2d)}
            run, plan = prep(model, scales)
            with torch.inference_mode():
                run(plan, torch.empty(batch, 3, size, size,
                                      dtype=torch.bfloat16))
    finally:
        mq.dwconv_i8 = orig
    return calls
