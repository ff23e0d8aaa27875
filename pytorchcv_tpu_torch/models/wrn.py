"""WRN (Wide ResNet for ImageNet-1K, NCHW): biased convs, no BatchNorm.
Counterpart of ``pytorchcv_tpu.models.wrn`` (reference pytorchcv
``models/wrn.py``), with its parameter paths
(``features.stage1.unit1.body.conv2.conv.weight``, ``...conv.bias``)."""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import ConvBlock, Sequential
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["WRNConv", "WRNBottleneck", "WRNUnit", "WRNInitBlock", "WRN",
           "get_wrn"]


def WRNConv(in_channels: int, out_channels: int, kernel_size: int,
            stride: int, padding: int, activate: bool) -> ConvBlock:
    """Biased conv + optional ReLU (reference wrn.py:12)."""
    return ConvBlock(in_channels, out_channels, kernel_size, stride=stride,
                     padding=padding, bias=True, normalization=False,
                     activation=activate)


class WRNBottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with widened mid channels; the stride sits on the
    3x3 (reference wrn.py:112)."""

    conv1_stride = False

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 width_factor: float):
        super().__init__()
        mid = int(round(out_channels // 4 * width_factor))
        self.conv1 = WRNConv(in_channels, mid, 1, 1, 0, True)
        self.conv2 = WRNConv(mid, mid, 3, stride, 1, True)
        self.conv3 = WRNConv(mid, out_channels, 1, 1, 0, False)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class WRNUnit(nn.Module):
    """Bottleneck body + identity (a biased 1x1 conv when the shape
    changes), added, then ReLU (reference wrn.py:158)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 width_factor: float):
        super().__init__()
        self.body = WRNBottleneck(in_channels, out_channels, stride,
                                  width_factor)
        if in_channels != out_channels or stride != 1:
            self.identity_conv = WRNConv(in_channels, out_channels, 1, stride,
                                         0, False)
        else:
            self.identity_conv = None
        self.activ = nn.ReLU()

    def forward(self, x):
        identity = x if self.identity_conv is None else self.identity_conv(x)
        return self.activ(self.body(x) + identity)


class WRNInitBlock(nn.Module):
    """7x7/2 biased conv + ReLU + 3x3/2 max-pool (reference wrn.py:205)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = WRNConv(in_channels, out_channels, 7, 2, 3, True)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x):
        return self.pool(self.conv(x))


def WRN(channels: Sequence[Sequence[int]], init_block_channels: int,
        width_factor: float, in_channels: int = 3,
        in_size: Tuple[int, int] = (224, 224),
        num_classes: int = 1000) -> ImageClassifier:
    """WRN (reference wrn.py:238)."""
    layers = [("init_block", WRNInitBlock(in_channels, init_block_channels))]
    c_in = init_block_channels
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            stride = 2 if j == 0 and i != 0 else 1
            units.append((f"unit{j + 1}", WRNUnit(c_in, c_out, stride,
                                                  width_factor)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    layers.append(("final_pool", nn.AdaptiveAvgPool2d(1)))
    return ImageClassifier(Sequential(layers), nn.Linear(c_in, num_classes),
                           in_size=in_size, in_channels=in_channels,
                           num_classes=num_classes)


_LAYERS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
           200: [3, 24, 36, 3]}


def get_wrn(blocks: int, width_factor: float, **kwargs) -> ImageClassifier:
    """Configuration expander (reference wrn.py:308)."""
    if blocks not in _LAYERS:
        raise ValueError(f"Unsupported WRN blocks: {blocks}")
    channels = [[c] * n for c, n in zip([256, 512, 1024, 2048],
                                        _LAYERS[blocks])]
    return WRN(channels, 64, width_factor, **kwargs)


@register_model("wrn50_2")
def wrn50_2(**kwargs):
    return get_wrn(blocks=50, width_factor=2.0, **kwargs)
