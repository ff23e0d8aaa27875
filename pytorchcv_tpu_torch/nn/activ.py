"""Activations as the blocks take them (counterpart of the factories in
``pytorchcv_tpu.nn.activ``): ``True`` is ReLU, ``False``/``None`` none, and
a factory such as ``lambda_leakyrelu(0.2)`` builds its module."""

from __future__ import annotations

from typing import Callable, Optional, Union

from torch import nn

__all__ = ["lambda_leakyrelu", "create_activation"]

Activation = Union[bool, None, Callable[[], nn.Module]]


def lambda_leakyrelu(negative_slope: float = 1e-2) -> Callable[[], nn.Module]:
    """Factory of ``nn.LeakyReLU(negative_slope)`` (JAX ``nn/activ.py:76``)."""
    return lambda: nn.LeakyReLU(negative_slope, inplace=True)


def create_activation(activation: Activation) -> Optional[nn.Module]:
    if activation is True:
        return nn.ReLU(inplace=True)
    if not activation:
        return None
    return activation()
