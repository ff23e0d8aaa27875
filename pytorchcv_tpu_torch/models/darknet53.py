"""DarkNet-53 for ImageNet-1K (NCHW). Counterpart of
``pytorchcv_tpu.models.darknet53``: leaky-ReLU (slope 0.1) conv blocks, a
3x3/s2 downsample conv opening each stage, then residual units of a 1x1
half-width conv and a 3x3 conv."""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import Sequential, conv1x1_block, conv3x3_block, lambda_leakyrelu
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["DarkUnit", "DarkNet53", "get_darknet53"]


class DarkUnit(nn.Module):
    """1x1 to half width -> 3x3 back, leaky ReLU after each, + the input
    (JAX ``models/darknet53.py:19``)."""

    def __init__(self, channels: int, alpha: float = 0.1):
        super().__init__()
        act = lambda_leakyrelu(alpha)
        self.conv1 = conv1x1_block(channels, channels // 2, activation=act)
        self.conv2 = conv3x3_block(channels // 2, channels, activation=act)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


def DarkNet53(channels: Sequence[Sequence[int]], init_block_channels: int,
              alpha: float = 0.1, in_channels: int = 3,
              in_size: Tuple[int, int] = (224, 224),
              num_classes: int = 1000) -> ImageClassifier:
    """DarkNet-53 (JAX ``models/darknet53.py:37``)."""
    act = lambda_leakyrelu(alpha)
    layers = [("init_block", conv3x3_block(in_channels, init_block_channels,
                                           activation=act))]
    c_in = init_block_channels
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            if j == 0:
                units.append(("unit1", conv3x3_block(c_in, c_out, stride=2,
                                                     activation=act)))
            else:
                units.append((f"unit{j + 1}", DarkUnit(c_out, alpha)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    layers.append(("final_pool", nn.AdaptiveAvgPool2d(1)))
    return ImageClassifier(Sequential(layers), nn.Linear(c_in, num_classes),
                           in_size=in_size, in_channels=in_channels,
                           num_classes=num_classes)


def get_darknet53(**kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/darknet53.py:63``)."""
    layers = [2, 3, 9, 9, 5]
    per_layer = [64, 128, 256, 512, 1024]
    channels = [[c] * n for c, n in zip(per_layer, layers)]
    return DarkNet53(channels, 32, **kwargs)


@register_model("darknet53")
def darknet53(**kwargs) -> ImageClassifier:
    return get_darknet53(**kwargs)
