"""Resampling, pooling and the hourglass's cut (counterparts in
``pytorchcv_tpu.nn.ops``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["interpolate", "grid_sample", "BreakBlock", "InterpolationBlock",
           "global_avg_pool2d"]


def interpolate(x, size: Tuple[int, int], mode: str = "bilinear",
                align_corners: bool = True):
    """NCHW resize to ``size``, torch semantics as the JAX package
    reproduces them (``nn/ops.py:141``); the identity at the input's own
    size. Bilinear with ``align_corners=True`` samples at
    ``i * (in-1)/(out-1)``, with ``False`` at half-pixel centers
    ``(i + 0.5) * in/out - 0.5`` (no antialias); nearest takes
    ``floor(i * in/out)``."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest")
    if mode != "bilinear":
        raise ValueError(f"interpolate: unsupported mode {mode!r}")
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners, antialias=False)


def grid_sample(x, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = False):
    """``F.grid_sample`` with f32 coordinates whatever x's type (JAX
    ``nn/ops.py:452``): ``x`` (B, C, H, W), ``grid`` (B, Hg, Wg, 2) of
    normalized (x, y). Nearest rounds half to even and zero padding tests
    the bounds after rounding, as the JAX function does; x of another type
    is sampled in f32 and rounded back."""
    out = F.grid_sample(x.to(torch.float32), grid.to(torch.float32),
                        mode=mode, padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(x.dtype)


class BreakBlock(nn.Module):
    """Returns None: cuts an hourglass skip (JAX ``nn/ops.py:41``)."""

    def forward(self, x):
        return None


class InterpolationBlock(nn.Module):
    """NCHW bilinear upsampling by ``scale_factor`` with
    ``align_corners=True`` (JAX ``nn/ops.py:168``)."""

    def __init__(self, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x):
        h, w = x.shape[2:]
        return interpolate(x, (h * self.scale_factor, w * self.scale_factor))


class _GlobalAvgPool2d(nn.Module):
    def __init__(self, keepdim: bool = False):
        super().__init__()
        self.keepdim = keepdim

    def forward(self, x):
        return x.mean((2, 3), keepdim=self.keepdim)


def global_avg_pool2d(keepdims: bool = False) -> nn.Module:
    """Mean over H and W: (B, C, H, W) -> (B, C), or (B, C, 1, 1) with
    ``keepdims`` (JAX ``nn/ops.py:355``)."""
    return _GlobalAvgPool2d(keepdims)
