"""The pre-activation stream step of the int8 PreResNet pipeline (K13).

A pre-activation unit's body ends in ``t`` (the last conv's ``acc * A``,
f32; bf16 where an SE gate follows), and the stream goes on in bf16. One
pass (``csrc/preact.cu``) takes, per element:

* ``gate`` (B, C) f32 or None: ``v = bf16(f32(bf16(t)) * gate)`` (the SE
  gate's product, JAX ``resnet_int8._se_gate``'s cast), else ``v = t``;
* ``identity`` (bf16: the stream ``r``; f32: the identity conv's output)
  or None: ``r' = bf16(v + f32(identity))``, returned; without one ``r' =
  v`` and nothing is written (``t`` is then the bf16 stream itself: the
  stem's pooled map into unit 1);
* ``bn`` = ``(g, b)`` f32 (C,) with ``q`` or None: the next unit's
  pre-activation ``pre = clip(rint(max(f32(r') * g + b, 0) * q), +-127)``
  int8, returned (None after the last unit).

JAX ``quant/preresnet_int8.py:_forward`` (:157, :171-181), every step one
f32 rounding in its op order, so the kernel and the plain version are
bit-exact against it (handed JAX's gate).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import (LAUNCHES, autograd_records, check, device_of, library,
                     require_cuda_or_cpu, stream_of)

__all__ = ["preact", "preact_reference", "kernel_info"]

_ID_NONE, _ID_BF16, _ID_F32 = 0, 1, 2

Pair = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def preact_reference(t: torch.Tensor, identity: Optional[torch.Tensor] = None,
                     gate: Optional[torch.Tensor] = None,
                     bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     q: Optional[float] = None) -> Pair:
    """Plain PyTorch version of K13: ``(r', pre)``."""
    v = t.to(torch.float32)
    if gate is not None:
        v = (v.to(torch.bfloat16).to(torch.float32) *
             gate[:, None, None, :]).to(torch.bfloat16).to(torch.float32)
    r = None
    if identity is not None:
        r = (v + identity.to(torch.float32)).to(torch.bfloat16)
        v = r.to(torch.float32)
    pre = None
    if bn is not None:
        y = torch.clamp_min(v * bn[0] + bn[1], 0.0)
        pre = torch.clamp(torch.round(y * q), -127.0, 127.0).to(torch.int8)
    return r, pre


def preact(t: torch.Tensor, identity: Optional[torch.Tensor] = None,
           gate: Optional[torch.Tensor] = None,
           bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           q: Optional[float] = None) -> Pair:
    """K13: ``t`` f32 or bf16 (B, H, W, C) -> ``(r', pre)`` as the module
    docstring says; ``q`` a float32 value. Without ``identity``, ``t`` must
    be the bf16 stream and ``gate`` None. CUDA tensors run the kernel, CPU
    tensors the plain version; a call autograd would record raises."""
    if t.dim() != 4 or t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"preact: t must be f32 or bf16 (B, H, W, C), got "
                         f"{t.dtype} {tuple(t.shape)}")
    bsz, h, w, c = t.shape
    if identity is None and (t.dtype != torch.bfloat16 or gate is not None):
        raise ValueError("preact: without an identity, t is the bf16 stream "
                         "and takes no gate")
    if identity is None and bn is None:
        raise ValueError("preact: a call with no identity and no bn writes "
                         "nothing")
    if identity is not None and (
            tuple(identity.shape) != tuple(t.shape) or
            identity.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"preact: identity must be f32 or bf16 of t's "
                         f"shape {tuple(t.shape)}")
    if gate is not None and (gate.dtype != torch.float32 or
                             tuple(gate.shape) != (bsz, c)):
        raise ValueError(f"preact: gate must be f32 ({bsz}, {c})")
    if bn is not None:
        if q is None or any(v.dtype != torch.float32 or
                            tuple(v.shape) != (c,) for v in bn):
            raise ValueError(f"preact: bn must be two f32 ({c},) with q")
    tensors = [x for x in (t, identity, gate, *(bn or ())) if x is not None]
    if autograd_records(*tensors):
        raise ValueError("preact: K13 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("preact", *tensors):
        return preact_reference(t, identity, gate, bn, q)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("preact: inputs must be contiguous")
    r = None if identity is None else torch.empty(
        t.shape, dtype=torch.bfloat16, device=t.device)
    pre = None if bn is None else torch.empty(t.shape, dtype=torch.int8,
                                              device=t.device)
    if t.numel() == 0:
        return r, pre
    id_mode = _ID_NONE if identity is None else (
        _ID_BF16 if identity.dtype == torch.bfloat16 else _ID_F32)
    with device_of(t):
        check(library().pcv_preact(
            t.data_ptr(), int(t.dtype == torch.bfloat16),
            None if gate is None else gate.data_ptr(),
            None if identity is None else identity.data_ptr(), id_mode,
            None if bn is None else bn[0].data_ptr(),
            None if bn is None else bn[1].data_ptr(), float(q or 0.0),
            None if r is None else r.data_ptr(),
            None if pre is None else pre.data_ptr(), bsz, h * w, c,
            stream_of(t)), "preact")
    LAUNCHES["preact"] += 1
    return r, pre


def kernel_info(vec: bool = True) -> dict:
    """Registers a thread and spilled (local) bytes of K13's 8-channel
    (``vec``) or one-element instance (needs the card)."""
    out = (ctypes.c_int * 2)()
    check(library().pcv_preact_info(int(vec), out), "preact info")
    return dict(zip(("registers", "spill_bytes"), out))
