"""BatchNorm and InstanceNorm as the blocks take them (counterpart of
``pytorchcv_tpu.nn.norm``), and BatchNorm's inference fold."""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

__all__ = ["BN_EPS", "lambda_batchnorm2d", "lambda_instancenorm2d",
           "fold_batchnorm"]

BN_EPS = 1e-5


def lambda_batchnorm2d(eps: float = BN_EPS) -> Callable[[int], nn.Module]:
    """Factory of ``nn.BatchNorm2d(channels, eps=eps)`` (JAX
    ``nn/norm.py:102``); EfficientNet's TF-ported variants take 1e-3."""
    return lambda channels: nn.BatchNorm2d(channels, eps=eps)


def lambda_instancenorm2d(eps: float = 1e-5, affine: bool = False
                          ) -> Callable[[int], nn.Module]:
    """Factory of ``nn.InstanceNorm2d(channels, eps=eps, affine=affine)``
    (JAX ``nn/norm.py:49, 106``): each sample's channel normalized over H
    and W by its mean and biased variance, with no running statistics, in
    eval mode too. RAFT's feature encoder takes it."""
    return lambda channels: nn.InstanceNorm2d(channels, eps=eps,
                                              affine=affine)


def fold_batchnorm(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN as f32 ``(scale, shift)``: ``g = gamma * rsqrt(var +
    eps)``, ``b = beta - mean * g``. Folded from the module's current
    tensors on every call, so it never goes stale."""
    g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return g, bn.bias.float() - bn.running_mean.float() * g
