"""The int8 ResNet serving stem (K3): folded bf16 7x7/s2 conv -> int8 pool.

``x`` planar bf16 (B, 3, H, W) is convolved with the BN-folded bf16 kernel
(7x7, stride 2, pad 3; bf16 x bf16 products summed in f32), the f32 bias is
added, ReLU applied and the result quantized to int8 with
``clip(rint(y * q), +-127)``; a 3x3/s2/pad-1 max-pool (pad value -128) then
gives the NHWC int8 input of stage 1 (``csrc/stem.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import (LAUNCHES, check, library, no_tf32, require_cuda_or_cpu,
                     stream_of)

__all__ = ["stem_conv_pool", "stem_conv_pool_reference"]

_MAX_COUT = 64


def _out_hw(h: int, w: int):
    ho, wo = (h + 6 - 7) // 2 + 1, (w + 6 - 7) // 2 + 1
    return ho, wo, (ho + 2 - 3) // 2 + 1, (wo + 2 - 3) // 2 + 1


def stem_conv_pool_reference(x: torch.Tensor, kf: torch.Tensor,
                             bias: torch.Tensor, q: float) -> torch.Tensor:
    """Plain PyTorch version of K3: an f32 conv (exact products, no TF32)
    and the same epilogue; the pool runs on the quantized values in f32,
    where -inf padding equals -128 because every value is >= 0."""
    w = kf.permute(3, 0, 1, 2).to(torch.float32)
    with no_tf32():
        y = F.conv2d(x.to(torch.float32), w, stride=2, padding=3)
    y = torch.clamp_min(y + bias[None, :, None, None], 0.0)
    yq = torch.clamp(torch.round(y * q), -127.0, 127.0)
    p = F.max_pool2d(yq, 3, 2, 1)
    return p.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def stem_conv_pool(x: torch.Tensor, kf: torch.Tensor, bias: torch.Tensor,
                   q: float) -> torch.Tensor:
    """K3: ``x`` bf16 (B, 3, H, W); ``kf`` bf16 (3, 7, 7, Cout), the folded
    kernel with input channel first; ``bias`` f32 (Cout,); ``q`` the f32
    quant factor. Returns int8 NHWC (B, Hp, Wp, Cout). CUDA tensors run the
    kernel, CPU tensors the plain version."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"stem: x must be bf16 (B,3,H,W), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if kf.dtype != torch.bfloat16 or tuple(kf.shape[:3]) != (3, 7, 7):
        raise ValueError(f"stem: kf must be bf16 (3,7,7,Cout), got "
                         f"{kf.dtype} {tuple(kf.shape)}")
    cout = kf.shape[3]
    if cout % 8 != 0 or cout > _MAX_COUT:
        raise ValueError(f"stem: Cout={cout} must be a multiple of 8, "
                         f"at most {_MAX_COUT}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (cout,):
        raise ValueError(f"stem: bias must be f32 ({cout},)")
    if not require_cuda_or_cpu("stem", x, kf, bias):
        return stem_conv_pool_reference(x, kf, bias, q)
    if not all(t.is_contiguous() for t in (x, kf, bias)):
        raise ValueError("stem: inputs must be contiguous")
    bsz, _, h, w = x.shape
    ho, wo, hp, wp = _out_hw(h, w)
    if bsz > 65535:
        raise ValueError("stem: batch exceeds 65535")
    conv = torch.empty((bsz, ho, wo, cout), dtype=torch.int8, device=x.device)
    out = torch.empty((bsz, hp, wp, cout), dtype=torch.int8, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        check(lib.pcv_stem(x.data_ptr(), kf.data_ptr(), bias.data_ptr(),
                           float(q), conv.data_ptr(), out.data_ptr(), bsz, h,
                           w, ho, wo, hp, wp, cout, stream_of(x)), "stem")
    LAUNCHES["stem"] += 1
    return out
