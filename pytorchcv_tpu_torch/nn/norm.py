"""BatchNorm as the blocks take it (counterpart of
``pytorchcv_tpu.nn.norm``), and its inference fold."""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

__all__ = ["BN_EPS", "lambda_batchnorm2d", "fold_batchnorm"]

BN_EPS = 1e-5


def lambda_batchnorm2d(eps: float = BN_EPS) -> Callable[[int], nn.Module]:
    """Factory of ``nn.BatchNorm2d(channels, eps=eps)`` (JAX
    ``nn/norm.py:102``); EfficientNet's TF-ported variants take 1e-3."""
    return lambda channels: nn.BatchNorm2d(channels, eps=eps)


def fold_batchnorm(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN as f32 ``(scale, shift)``: ``g = gamma * rsqrt(var +
    eps)``, ``b = beta - mean * g``. Folded from the module's current
    tensors on every call, so it never goes stale."""
    g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return g, bn.bias.float() - bn.running_mean.float() * g
