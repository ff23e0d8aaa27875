"""The squeeze-and-excitation unit's tail of the int8 ResNet pipeline (K11)
and its gate.

For an SE unit (SE-ResNet, SE-ResNeXt, SENet) the last conv writes ``t``
bf16 (kernel K2, no tail); :func:`se_gate` computes the gate from it with
plain torch calls (the f32 mean over H and W, the two small products, ReLU
and sigmoid: JAX ``_se_gate``, XLA ops on the TPU); :func:`se_tail` then
runs, per element, in one pass:

* ``s = bf16(t * g)`` (the gated body, JAX ``_se_gate``'s cast);
* ``r``: an int8 residual as ``f32(res) * res_scale``, rounded to bf16 with
  ``round_res`` (the unit's own int8 input), not rounded without it (the
  int8 identity conv at the next unit's scale); or a bf16 residual as it is
  (the bf16 identity conv of the last unit);
* ``y = max(s + r, 0)``; int8 ``clip(rint(y * q), +-127)``, or bf16 without
  ``q`` (after the last unit).

Every step is one f32 rounding in the JAX op order, so the kernel
(``csrc/se_tail.cu``) and the plain version are bit-exact against the JAX
pipeline's tail when handed its gate.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import (LAUNCHES, autograd_records, check, device_of, library,
                     no_tf32, require_cuda_or_cpu, stream_of)

__all__ = ["se_gate", "se_tail", "se_tail_reference"]

_RES_I8, _RES_I8_BF16, _RES_BF16 = 1, 2, 3


def se_gate(t: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
            k2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The SE gate of ``t`` (B, H, W, C) bf16: ``sigmoid(relu(mean(t) @ k1
    + b1) @ k2 + b2)``, f32 (B, C); ``k1`` (C, M), ``k2`` (M, C) f32 (JAX
    ``resnet_int8._se_gate``). Plain torch calls, f32 products without
    TF32; the mean accumulates in f32 without an f32 copy of t."""
    p = torch.mean(t, dim=(1, 2), dtype=torch.float32)
    with no_tf32():
        h = torch.relu(torch.matmul(p, k1) + b1)
        return torch.sigmoid(torch.matmul(h, k2) + b2)


def se_tail_reference(t: torch.Tensor, g: torch.Tensor,
                      residual: torch.Tensor,
                      res_scale: Optional[float] = None,
                      round_res: bool = False,
                      q: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K11."""
    s = (t.to(torch.float32) * g[:, None, None, :]).to(torch.bfloat16)
    if residual.dtype == torch.int8:
        r = residual.to(torch.float32) * res_scale
        if round_res:
            r = r.to(torch.bfloat16).to(torch.float32)
    else:
        r = residual.to(torch.float32)
    y = torch.clamp_min(s.to(torch.float32) + r, 0.0)
    if q is None:
        return y.to(torch.bfloat16)
    return torch.clamp(torch.round(y * q), -127.0, 127.0).to(torch.int8)


def se_tail(t: torch.Tensor, g: torch.Tensor, residual: torch.Tensor,
            res_scale: Optional[float] = None, round_res: bool = False,
            q: Optional[float] = None) -> torch.Tensor:
    """K11: ``t`` bf16 (B, H, W, C), ``g`` f32 (B, C), ``residual`` int8 (with
    ``res_scale``, a float32 value) or bf16 of t's shape -> int8 at ``q``,
    or bf16 without it (module docstring). CUDA tensors run the kernel, CPU
    tensors the plain version; a call autograd would record raises."""
    if t.dtype != torch.bfloat16 or t.dim() != 4:
        raise ValueError(f"se_tail: t must be bf16 (B, H, W, C), got "
                         f"{t.dtype} {tuple(t.shape)}")
    bsz, h, w, c = t.shape
    if g.dtype != torch.float32 or tuple(g.shape) != (bsz, c):
        raise ValueError(f"se_tail: g must be f32 ({bsz}, {c}), got "
                         f"{g.dtype} {tuple(g.shape)}")
    if tuple(residual.shape) != tuple(t.shape):
        raise ValueError(f"se_tail: residual {tuple(residual.shape)} != t "
                         f"{tuple(t.shape)}")
    if residual.dtype == torch.int8:
        if res_scale is None:
            raise ValueError("se_tail: an int8 residual needs res_scale")
        mode = _RES_I8_BF16 if round_res else _RES_I8
    elif residual.dtype == torch.bfloat16:
        mode = _RES_BF16
    else:
        raise ValueError(f"se_tail: residual dtype {residual.dtype}")
    if autograd_records(t, g, residual):
        raise ValueError("se_tail: K11 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("se_tail", t, g, residual):
        return se_tail_reference(t, g, residual, res_scale, round_res, q)
    if not all(x.is_contiguous() for x in (t, g, residual)):
        raise ValueError("se_tail: inputs must be contiguous")
    out = torch.empty(t.shape, dtype=torch.int8 if q is not None
                      else torch.bfloat16, device=t.device)
    if t.numel() == 0:
        return out
    with device_of(t):
        check(library().pcv_se_tail(
            t.data_ptr(), g.data_ptr(), residual.data_ptr(), mode,
            float(res_scale or 0.0), float(q or 0.0), int(q is not None),
            out.data_ptr(), bsz, h * w, c, stream_of(t)), "se_tail")
    LAUNCHES["se_tail"] += 1
    return out
