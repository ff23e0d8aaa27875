"""Windowed multi-head attention (K7): ``softmax(q k^T * scale + mask) v``
for each of the leading dims' problems (batch x windows x heads).

ProPainter's sparse window attention (``models/propainter.py``) runs it
twice per transformer block: over a window's tokens of every frame against
the window's, the rolled and the pooled tokens of the sampled frames (the
full path: Lq 810, Lk 2142 at 18 frames), and within each frame's window
(the local path: Lq = Lk = 45). The kernel (``csrc/window_attention.cu``)
streams k and v tiles through shared memory with the running-max /
running-sum rescaling, so the (Lq, Lk) scores never reach device memory;
the TPU kernel it replaces (``pytorchcv_tpu/kernels/attention.py``) held a
problem's whole score tile in VMEM. The function is f32's: the kernel runs
both products on the tensor cores as three TF32 products each (x = hi +
lo, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi), the softmax in f32, and the
output is q's type. Counterpart of that module's ``fused_window_attention``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import (LAUNCHES, autograd_records, check, library, no_tf32,
                     require_cuda_or_cpu, stream_of)

__all__ = ["fused_window_attention", "fused_window_attention_reference",
           "kernel_info"]

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = 128
_BQ = 64                       # query rows a block of the kernel (Lq > 48)


def fused_window_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, scale: float,
                                     mask: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version (JAX ``kernels/attention.py:_xla_ref``): dense
    f32 scores times ``scale``, plus the mask, softmax, then ``@ v`` in f32
    with TF32 off, cast to q's type."""
    with no_tf32():
        s = torch.matmul(q.to(torch.float32),
                         k.to(torch.float32).transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask.to(torch.float32)
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: Optional[float] = None,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K7: ``q`` (..., Lq, D), ``k`` and ``v`` (..., Lk, D), one dtype (bf16
    or f32), D <= 128; ``scale`` defaults to D ** -0.5; ``mask``, additive,
    broadcast to (..., Lq, Lk) as the JAX function broadcasts it. Returns
    (..., Lq, D) in q's dtype.

    Anything else raises, a call that autograd would record included (K7
    has no backward yet). CUDA tensors run the kernel at every size, CPU
    tensors the plain version."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"window_attention: q, k, v must share one dtype of "
                         f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() < 2 or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("window_attention: q, k, v must have the same rank "
                         ">= 2")
    lead, (lq, d) = q.shape[:-2], q.shape[-2:]
    lk = k.shape[-2]
    if k.shape[:-2] != lead or v.shape[:-2] != lead or \
            tuple(k.shape[-2:]) != (lk, d) or tuple(v.shape[-2:]) != (lk, d):
        raise ValueError(f"window_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not 1 <= d <= _MAX_D or lq < 1 or lk < 1:
        raise ValueError(f"window_attention: need 1 <= D <= {_MAX_D} and "
                         f"non-empty Lq, Lk, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if scale is None:
        scale = d ** -0.5
    tensors = (q, k, v) if mask is None else (q, k, v, mask)
    if autograd_records(*tensors):
        raise ValueError("window_attention: K7 has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    if mask is not None:
        mask = torch.broadcast_to(mask.to(torch.float32), (*lead, lq, lk))
    if not require_cuda_or_cpu("window_attention", *tensors):
        return fused_window_attention_reference(q, k, v, scale, mask)
    n = math.prod(lead)
    if n >= 2 ** 31 or -(-lq // _BQ) > 65535:
        raise ValueError(f"window_attention: {n} problems of Lq {lq} exceed "
                         f"the kernel's grid")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if mask is not None:
        mask = mask.contiguous()
    out = torch.empty((*lead, lq, d), dtype=q.dtype, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        check(lib.pcv_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), n, lq,
            lk, d, float(scale), int(q.dtype == torch.bfloat16),
            stream_of(q)), "window_attention")
    LAUNCHES["window_attention"] += 1
    return out


def kernel_info(d: int, dtype=torch.float32, lq: int = 810) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of the instance K7 launches for head width ``d``,
    ``dtype`` and ``lq`` query rows (needs the card)."""
    out = (ctypes.c_int * 4)()
    check(library().pcv_window_attention_info(
        d, int(dtype == torch.bfloat16), lq, out), "window_attention info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out))
