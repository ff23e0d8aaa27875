"""ResNeXt for ImageNet-1K (NCHW), with the reference pytorchcv module names.
Counterpart of ``pytorchcv_tpu.models.resnext``: the same 10 registered
names and the same ``get_resnext`` configuration table. The grouped 3x3 is
an ``nn.Conv2d`` with ``groups=cardinality``."""

from __future__ import annotations

import math
from typing import Sequence

from torch import nn

from ..nn import conv1x1_block, conv3x3_block
from .registry import register_model
from .resnet import classifier
from .shell import ImageClassifier

__all__ = ["ResNeXtBottleneck", "ResNeXtUnit", "ResNeXt", "get_resnext",
           "group_width"]


def group_width(out_channels: int, cardinality: int, bottleneck_width: int,
                bottleneck_factor: int = 4) -> int:
    """Width of the grouped 3x3: cardinality x D, D = floor(mid x
    bottleneck_width / 64) (JAX ``models/resnext.py:33-35``)."""
    mid = out_channels // bottleneck_factor
    return cardinality * int(math.floor(mid * (bottleneck_width / 64.0)))


class ResNeXtBottleneck(nn.Module):
    """1x1 -> grouped 3x3 (the stride) -> 1x1 (JAX
    ``models/resnext.py:23``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 cardinality: int, bottleneck_width: int):
        super().__init__()
        gw = group_width(out_channels, cardinality, bottleneck_width)
        self.conv1 = conv1x1_block(in_channels, gw)
        self.conv2 = conv3x3_block(gw, gw, stride=stride, groups=cardinality)
        self.conv3 = conv1x1_block(gw, out_channels, activation=False)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class ResNeXtUnit(nn.Module):
    """body + identity (a 1x1 conv block when the shape changes), added,
    then ReLU (JAX ``models/resnext.py:47``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 cardinality: int, bottleneck_width: int):
        super().__init__()
        self.body = ResNeXtBottleneck(in_channels, out_channels, stride,
                                      cardinality, bottleneck_width)
        if in_channels != out_channels or stride != 1:
            self.identity_conv = conv1x1_block(in_channels, out_channels,
                                               stride=stride,
                                               activation=False)
        else:
            self.identity_conv = None
        self.activ = nn.ReLU()

    def forward(self, x):
        identity = x if self.identity_conv is None else self.identity_conv(x)
        return self.activ(self.body(x) + identity)


def ResNeXt(channels: Sequence[Sequence[int]], init_block_channels: int,
            cardinality: int, bottleneck_width: int,
            **kwargs) -> ImageClassifier:
    """ResNeXt (JAX ``models/resnext.py:73``)."""
    def unit(c_in, c_out, stride, _stage):
        return ResNeXtUnit(c_in, c_out, stride, cardinality,
                           bottleneck_width)
    return classifier(channels, init_block_channels, unit, **kwargs)


_LAYERS = {14: [1, 1, 1, 1], 26: [2, 2, 2, 2], 38: [3, 3, 3, 3],
           50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


def stage_channels(layers: Sequence[int]):
    """[[256] x n1, [512] x n2, [1024] x n3, [2048] x n4]."""
    return [[c] * n for c, n in zip((256, 512, 1024, 2048), layers)]


def get_resnext(blocks: int, cardinality: int, bottleneck_width: int,
                **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/resnext.py:101``)."""
    if blocks not in _LAYERS:
        raise ValueError(f"Unsupported ResNeXt blocks: {blocks}")
    return ResNeXt(stage_channels(_LAYERS[blocks]), 64, cardinality,
                   bottleneck_width, **kwargs)


def _register(name: str, blocks: int, cardinality: int, width: int):
    def ctor(**kwargs):
        return get_resnext(blocks, cardinality, width, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _cfg in {
        "resnext14_16x4d": (14, 16, 4), "resnext14_32x2d": (14, 32, 2),
        "resnext14_32x4d": (14, 32, 4), "resnext26_16x4d": (26, 16, 4),
        "resnext26_32x2d": (26, 32, 2), "resnext26_32x4d": (26, 32, 4),
        "resnext38_32x4d": (38, 32, 4), "resnext50_32x4d": (50, 32, 4),
        "resnext101_32x4d": (101, 32, 4),
        "resnext101_64x4d": (101, 64, 4)}.items():
    _register(_name, *_cfg)
