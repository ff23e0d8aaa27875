"""Flash (online-softmax) attention (K4): ``softmax(q k^T * scale) v``.

DANet's position attention runs it over L = H*W tokens, 3600 at the 480x480
Cityscapes protocol, where the dense (L, L) f32 score matrix is 52 MB per
image. The kernel (``csrc/flash_attention.cu``) streams k and v tiles
through shared memory with the running-max / running-sum rescaling, so the
scores never reach device memory. The function is f32's, as in the TPU
kernel it replaces (``pytorchcv_tpu/kernels/flash_attention.py``): bf16
inputs run on the tensor cores (exact bf16 products, f32 sums, p split
into two bf16 terms for ``p v``), f32 inputs on the CUDA cores; the output
is cast to q's type. Counterpart of that module's ``flash_attention``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import (LAUNCHES, autograd_records, check, library, no_tf32,
                     require_cuda_or_cpu, stream_of)

__all__ = ["flash_attention", "flash_attention_reference", "kernel_info"]

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float = 1.0
                              ) -> torch.Tensor:
    """Plain PyTorch version: dense f32 scores, softmax, then ``@ v``, cast
    to q's type (JAX ``kernels/attention.py:_xla_ref``)."""
    with no_tf32():
        s = torch.matmul(q.to(torch.float32),
                         k.to(torch.float32).transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float = 1.0) -> torch.Tensor:
    """K4: ``q`` (..., Lq, d), ``k`` (..., Lk, d), ``v`` (..., Lk, dv), one
    dtype (bf16 or f32), d <= 128 -> (..., Lq, dv) in q's dtype. CUDA
    tensors run the kernel at every size, CPU tensors the plain version.
    A call that autograd would record raises (K4 has no backward; callers
    take ``flash_attention_reference`` then)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() < 2 or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("flash_attention: q, k, v must have the same rank "
                         ">= 2")
    lead, (lq, d) = q.shape[:-2], q.shape[-2:]
    lk, dv = v.shape[-2:]
    if k.shape[:-2] != lead or v.shape[:-2] != lead or \
            tuple(k.shape[-2:]) != (lk, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not 1 <= d <= _MAX_D or lq < 1 or lk < 1 or dv < 1:
        raise ValueError(f"flash_attention: need 1 <= d <= {_MAX_D} and "
                         f"non-empty L and dv, got {tuple(q.shape)}, "
                         f"{tuple(v.shape)}")
    if autograd_records(q, k, v):
        raise ValueError("flash_attention: K4 has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("flash_attention", q, k, v):
        return flash_attention_reference(q, k, v, scale)
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: inputs must be contiguous")
    n = q.numel() // (lq * d)
    if n > 65535:
        raise ValueError("flash_attention: batch exceeds 65535")
    out = torch.empty((*lead, lq, dv), dtype=q.dtype, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        check(lib.pcv_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, lq,
            lk, d, dv, float(scale), int(q.dtype == torch.bfloat16),
            stream_of(q)), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def kernel_info(d: int, dtype=torch.bfloat16) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of the instance K4 launches for head width ``d`` and
    ``dtype`` (needs the card)."""
    out = (ctypes.c_int * 4)()
    check(library().pcv_flash_attention_info(
        d, int(dtype == torch.bfloat16), out), "flash_attention info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out))
