"""Squeeze-and-excitation (counterpart of ``pytorchcv_tpu.nn.att``)."""

from __future__ import annotations

from torch import nn

from .activ import Activation, create_activation, lambda_sigmoid
from .conv import conv1x1

__all__ = ["round_channels", "SEBlock"]


def round_channels(channels: float, divisor: int = 8) -> int:
    """``channels`` rounded to a multiple of ``divisor``, never below 90 %
    of it (JAX ``nn/att.py:25``)."""
    rounded = max(int(channels + divisor / 2.0) // divisor * divisor,
                  divisor)
    if float(rounded) < 0.9 * channels:
        rounded += divisor
    return rounded


class SEBlock(nn.Module):
    """Squeeze-and-excitation gate with 1x1 convs (JAX ``nn/att.py:34``,
    ``use_conv=True``): mean over H and W -> 1x1 conv with bias ->
    ``mid_activation`` -> 1x1 conv with bias -> ``out_activation`` -> scale
    the input. Children ``conv1``, ``activ``, ``conv2``, ``sigmoid``."""

    def __init__(self, channels: int, reduction: int = 16,
                 mid_activation: Activation = True,
                 out_activation: Activation = lambda_sigmoid()):
        super().__init__()
        mid = channels // reduction
        self.conv1 = conv1x1(channels, mid, bias=True)
        self.activ = create_activation(mid_activation)
        self.conv2 = conv1x1(mid, channels, bias=True)
        self.sigmoid = create_activation(out_activation)

    def forward(self, x):
        w = x.mean((2, 3), keepdim=True)
        w = self.sigmoid(self.conv2(self.activ(self.conv1(w))))
        return x * w
