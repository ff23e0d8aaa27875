"""Resampling and the hourglass's cut (counterparts in
``pytorchcv_tpu.nn.ops``)."""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import nn

__all__ = ["interpolate", "BreakBlock", "InterpolationBlock"]


def interpolate(x, size: Tuple[int, int]):
    """NCHW bilinear resize to ``size`` with ``align_corners=True`` (samples
    at ``i * (in-1)/(out-1)``, torch semantics, as the JAX package
    reproduces them); the identity at the input's own size."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


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
