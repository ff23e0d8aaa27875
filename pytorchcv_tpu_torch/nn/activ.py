"""Activations as the blocks take them (counterpart of the factories in
``pytorchcv_tpu.nn.activ``): ``True`` is ReLU, ``False``/``None`` none, and
a factory such as ``lambda_leakyrelu(0.2)`` builds its module."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ..kernels._build import div6

__all__ = ["Swish", "HSigmoid", "HSwish", "lambda_relu", "lambda_relu6",
           "lambda_leakyrelu", "lambda_swish", "lambda_hsigmoid",
           "lambda_hswish", "lambda_sigmoid", "lambda_tanh",
           "create_activation"]

Activation = Union[bool, None, Callable[[], nn.Module]]


def lambda_relu() -> Callable[[], nn.Module]:
    """Factory of ``nn.ReLU`` (JAX ``nn/activ.py:61``)."""
    return lambda: nn.ReLU(inplace=True)


def lambda_relu6() -> Callable[[], nn.Module]:
    """Factory of ``nn.ReLU6``, ``clip(x, 0, 6)`` (JAX ``nn/activ.py:66``)."""
    return lambda: nn.ReLU6(inplace=True)


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


class HSigmoid(nn.Module):
    """``relu6(x + 3) / 6`` (JAX ``nn/activ.py:30``): it divides by 6."""

    def forward(self, x):
        return div6(nn.functional.relu6(x + 3.0))


class HSwish(nn.Module):
    """``x * relu6(x + 3) / 6`` (JAX ``nn/activ.py:35``), the product
    first, then the division by 6 (not a product by 1/6)."""

    def forward(self, x):
        return div6(x * nn.functional.relu6(x + 3.0))


def lambda_hsigmoid() -> Callable[[], nn.Module]:
    """Factory of :class:`HSigmoid` (JAX ``nn/activ.py:90``)."""
    return HSigmoid


def lambda_hswish() -> Callable[[], nn.Module]:
    """Factory of :class:`HSwish` (JAX ``nn/activ.py:98``)."""
    return HSwish


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
