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
    """Squeeze-and-excitation gate (JAX ``nn/att.py:34``): mean over H and
    W -> 1x1 conv with bias -> ``mid_activation`` -> 1x1 conv with bias ->
    ``out_activation`` -> scale the input. Children ``conv1``, ``activ``,
    ``conv2``, ``sigmoid``; with ``use_conv=False`` the two products are
    ``nn.Linear`` children ``fc1`` and ``fc2`` (Fast-SE-ResNet's gates).
    The middle width is ``channels // reduction``, or with ``round_mid``
    ``round_channels(channels / reduction)`` (MobileNetV3's gates, whose
    ``out_activation`` is ``lambda_hsigmoid()``)."""

    def __init__(self, channels: int, reduction: int = 16,
                 mid_activation: Activation = True,
                 out_activation: Activation = lambda_sigmoid(),
                 round_mid: bool = False, use_conv: bool = True):
        super().__init__()
        mid = round_channels(float(channels) / reduction) if round_mid \
            else channels // reduction
        self.use_conv = use_conv
        if use_conv:
            self.conv1 = conv1x1(channels, mid, bias=True)
        else:
            self.fc1 = nn.Linear(channels, mid)
        self.activ = create_activation(mid_activation)
        if use_conv:
            self.conv2 = conv1x1(mid, channels, bias=True)
        else:
            self.fc2 = nn.Linear(mid, channels)
        self.sigmoid = create_activation(out_activation)

    def forward(self, x):
        if not self.use_conv:
            w = self.fc2(self.activ(self.fc1(x.mean((2, 3)))))
            return x * self.sigmoid(w)[:, :, None, None]
        w = x.mean((2, 3), keepdim=True)
        w = self.sigmoid(self.conv2(self.activ(self.conv1(w))))
        return x * w
