"""Modulated deformable convolution v2 (torchvision ``deform_conv2d``
semantics), NCHW. Counterpart of ``pytorchcv_tpu.nn.deform``.

Two routes, one function:

- **bounded-offset route** (K5): a caller whose offsets are ``center +
  residual`` with ``|residual| <= residue_bound`` opts in by passing
  ``center`` and ``residue_bound`` (ProPainter's alignment). At a 3x3
  kernel, stride 1, padding 1, batch 1 and H, W >= P = 2*ceil(bound) + 4,
  ``kernels.deform_patch.deform_sample`` samples the taps (the CUDA kernel
  on the card, its plain version on the CPU) and ``torch.matmul`` applies
  the (9*C, O) weight matrix. The JAX package also asks that the feature
  map fit the TPU's VMEM; the card has no such limit, so the port does not.
  ``center`` marks the contract and is not read: the kernel reads each
  sample's corners directly, without the window the center places.
- **general route**: every other call (any kernel size, stride, padding,
  batch). The same sampling arithmetic in plain PyTorch (four corners, zero
  outside the image, f32 positions), then the same product. A K5 build or
  launch failure raises; it never falls back here.

Layouts: ``offset`` (B, 2*G*K2, Ho, Wo) with (y, x) pairs per (group, tap),
``mask`` (B, G*K2, Ho, Wo) after the sigmoid, ``weight`` (O, C, kh, kw).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.deform_patch import (bilinear_taps, deform_sample,
                                    tap_positions, window_size)

__all__ = ["deform_conv2d"]


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1, deform_groups: int = 1,
                  center: Optional[torch.Tensor] = None,
                  residue_bound: Optional[float] = None) -> torch.Tensor:
    """``x`` (B, C, H, W) -> (B, O, Ho, Wo), Ho and Wo from ``offset``."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    ho, wo = offset.shape[2:]
    if (center is not None and residue_bound is not None and stride == 1
            and padding == 1 and (kh, kw) == (3, 3) and b == 1
            and min(h, w) >= window_size(residue_bound)):
        taps = deform_sample(x, offset, mask, deform_groups, residue_bound)
        taps = taps.view(1, h * w, 9 * c)
    else:
        py, px, m = tap_positions(offset, mask, deform_groups, (kh, kw),
                                  stride, padding, x.dtype)
        taps = bilinear_taps(x, py, px, m).to(x.dtype).reshape(
            b, ho * wo, kh * kw * c)
    w_mat = weight.permute(0, 2, 3, 1).reshape(o, kh * kw * c)
    out = torch.matmul(w_mat, taps.transpose(1, 2))
    if bias is not None:
        out = out + bias.view(1, o, 1)
    return out.view(b, o, ho, wo)
