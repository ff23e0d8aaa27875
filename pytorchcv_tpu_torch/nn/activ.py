"""Activations as the blocks take them (counterpart of the factories in
``pytorchcv_tpu.nn.activ``): ``True`` is ReLU, ``False``/``None`` none, and
a factory such as ``lambda_leakyrelu(0.2)`` builds its module."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

__all__ = ["Swish", "lambda_leakyrelu", "lambda_swish", "lambda_sigmoid",
           "lambda_tanh", "create_activation"]

Activation = Union[bool, None, Callable[[], nn.Module]]


def lambda_leakyrelu(negative_slope: float = 1e-2) -> Callable[[], nn.Module]:
    """Factory of ``nn.LeakyReLU(negative_slope)`` (JAX ``nn/activ.py:76``)."""
    return lambda: nn.LeakyReLU(negative_slope, inplace=True)


class Swish(nn.Module):
    """``x * sigmoid(x)``, two rounded operations as in the JAX package
    (``nn/activ.py:25``); ``nn.SiLU`` rounds once in bf16."""

    def forward(self, x):
        return x * torch.sigmoid(x)


def lambda_swish() -> Callable[[], nn.Module]:
    """Factory of :class:`Swish` (JAX ``nn/activ.py``)."""
    return Swish


def lambda_sigmoid() -> Callable[[], nn.Module]:
    """Factory of ``nn.Sigmoid`` (JAX ``nn/activ.py``)."""
    return nn.Sigmoid


def lambda_tanh() -> Callable[[], nn.Module]:
    """Factory of ``nn.Tanh`` (JAX ``nn/activ.py:86``)."""
    return nn.Tanh


def create_activation(activation: Activation) -> Optional[nn.Module]:
    if activation is True:
        return nn.ReLU(inplace=True)
    if not activation:
        return None
    return activation()
