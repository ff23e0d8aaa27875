"""The serving stems of the int8 pipelines (K3), and their int8 max-pool.

``stem_conv``: ``x`` planar bf16 (B, 3, H, W) is convolved with a BN-folded
bf16 kernel (k x k, stride 2, pad k // 2, with k = 7 for the ResNet stem
and k = 3 for conv1 of the SENet deep stem; bf16 x bf16 products summed in
f32), the f32 bias is added, ReLU applied and the result quantized to int8
NHWC with ``clip(rint(y * q), +-127)``. ``maxpool_i8`` is the 3x3/s2/pad-1
int8 max-pool (pad value -128) that follows it (the ResNet stem) or the
deep stem's int8 conv2 and conv3. Both run ``csrc/stem.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import (LAUNCHES, check, library, no_tf32, require_cuda_or_cpu,
                     stream_of)

__all__ = ["stem_conv", "stem_conv_reference", "maxpool_i8",
           "maxpool_i8_reference"]

_MAX_COUT = 64
_KSIZES = (3, 7)


def maxpool_i8_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pool, in f32: every window holds at
    least one pixel, so -inf padding gives what pad value -128 gives."""
    p = F.max_pool2d(x.permute(0, 3, 1, 2).to(torch.float32), 3, 2, 1)
    return p.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def stem_conv_reference(x: torch.Tensor, kf: torch.Tensor,
                        bias: torch.Tensor, q: float) -> torch.Tensor:
    """Plain PyTorch version of K3: an f32 conv (exact products, no TF32)
    and the same epilogue."""
    w = kf.permute(3, 0, 1, 2).to(torch.float32)
    with no_tf32():
        y = F.conv2d(x.to(torch.float32), w, stride=2,
                     padding=kf.shape[1] // 2)
    y = torch.clamp_min(y + bias[None, :, None, None], 0.0)
    yq = torch.clamp(torch.round(y * q), -127.0, 127.0).to(torch.int8)
    return yq.permute(0, 2, 3, 1).contiguous()


def stem_conv(x: torch.Tensor, kf: torch.Tensor, bias: torch.Tensor,
              q: float) -> torch.Tensor:
    """K3: ``x`` bf16 (B, 3, H, W); ``kf`` bf16 (3, k, k, Cout) with k in
    (3, 7), the folded kernel with input channel first; ``bias`` f32
    (Cout,); ``q`` the f32 quant factor. Returns int8 NHWC. CUDA tensors
    run the kernel, CPU tensors the plain version."""
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
        return stem_conv_reference(x, kf, bias, q)
    if not all(t.is_contiguous() for t in (x, kf, bias)):
        raise ValueError("stem: inputs must be contiguous")
    bsz, _, h, w = x.shape
    if bsz > 65535:
        raise ValueError("stem: batch exceeds 65535")
    pad = k // 2
    ho, wo = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        check(library().pcv_stem(x.data_ptr(), kf.data_ptr(), bias.data_ptr(),
                                 float(q), k, out.data_ptr(), bsz, h, w, ho,
                                 wo, cout, stream_of(x)), "stem")
    LAUNCHES["stem"] += 1
    return out


def maxpool_i8(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2/pad-1 max-pool of an int8 NHWC map, pad value -128 (JAX
    ``quant/resnet_int8.py:_maxpool_i8``). CUDA tensors run the kernel, CPU
    tensors the plain version."""
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"maxpool_i8: x must be int8 NHWC, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not require_cuda_or_cpu("maxpool_i8", x):
        return maxpool_i8_reference(x)
    if not x.is_contiguous():
        raise ValueError("maxpool_i8: x must be contiguous")
    bsz, h, w, c = x.shape
    hp, wp = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    out = torch.empty((bsz, hp, wp, c), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        check(library().pcv_maxpool_i8(x.data_ptr(), out.data_ptr(), bsz, h,
                                       w, hp, wp, c, stream_of(x)),
              "maxpool_i8")
    LAUNCHES["maxpool_i8"] += 1
    return out
