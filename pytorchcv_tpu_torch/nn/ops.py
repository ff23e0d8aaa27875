"""Resampling (counterpart of ``pytorchcv_tpu.nn.ops.interpolate``)."""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F

__all__ = ["interpolate"]


def interpolate(x, size: Tuple[int, int]):
    """NCHW bilinear resize to ``size`` with ``align_corners=True`` (samples
    at ``i * (in-1)/(out-1)``, torch semantics, as the JAX package
    reproduces them); the identity at the input's own size."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)
