"""MobileNetV2 and its B variant, NCHW, with the reference pytorchcv
module names (``features.stage2.unit1.conv2.conv.weight``, ...).
Counterpart of ``pytorchcv_tpu.models.mobilenetv2``: the same 8 registered
names and channel plans.

The depthwise blocks (BN, ReLU6) run in eval mode as one K6 launch each
(``kernels.dwconv``, the bf16 route); the int8 route serves the model
through ``quant.mobilenet_int8``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import (Sequential, conv1x1, conv1x1_block, conv3x3_block,
                  dwconv3x3_block, global_avg_pool2d, lambda_relu6)
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["LinearBottleneck", "mobilenetv2", "get_mobilenetv2"]


class LinearBottleneck(nn.Module):
    """1x1 expansion -> depthwise 3x3 -> linear 1x1 projection, residual
    where the shape holds (JAX ``models/mobilenetv2.py:22``). The expansion
    is 6x with ``expansion``; without it the unit keeps its width and, with
    ``remove_exp_conv``, has no expansion conv (v2b)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 expansion: bool, remove_exp_conv: bool):
        super().__init__()
        self.residual = in_channels == out_channels and stride == 1
        mid = in_channels * 6 if expansion else in_channels
        act = lambda_relu6()
        self.conv1 = conv1x1_block(in_channels, mid, activation=act) \
            if expansion or not remove_exp_conv else None
        self.conv2 = dwconv3x3_block(mid, mid, stride=stride, activation=act)
        self.conv3 = conv1x1_block(mid, out_channels, activation=None)

    def forward(self, x):
        identity = x
        if self.conv1 is not None:
            x = self.conv1(x)
        x = self.conv3(self.conv2(x))
        return x + identity if self.residual else x


def mobilenetv2(channels: Sequence[Sequence[int]], init_block_channels: int,
                final_block_channels: int, remove_exp_conv: bool,
                in_channels: int = 3, in_size: Tuple[int, int] = (224, 224),
                num_classes: int = 1000) -> ImageClassifier:
    """MobileNetV2 (JAX ``models/mobilenetv2.py:53``): the classifier is a
    bias-free 1x1 conv on the pooled (B, C, 1, 1) feature."""
    act = lambda_relu6()
    layers = [("init_block", conv3x3_block(in_channels, init_block_channels,
                                           stride=2, activation=act))]
    c_in = init_block_channels
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            units.append((f"unit{j + 1}", LinearBottleneck(
                c_in, c_out, stride=2 if j == 0 and i != 0 else 1,
                expansion=i != 0 or j != 0,
                remove_exp_conv=remove_exp_conv)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    layers.append(("final_block", conv1x1_block(c_in, final_block_channels,
                                                activation=act)))
    layers.append(("final_pool", global_avg_pool2d(keepdims=True)))
    return ImageClassifier(Sequential(layers),
                           conv1x1(final_block_channels, num_classes),
                           in_size=in_size, in_channels=in_channels,
                           num_classes=num_classes,
                           output_before_flatten=True)


def get_mobilenetv2(width_scale: float, remove_exp_conv: bool = False,
                    **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/mobilenetv2.py:81``)."""
    init_block_channels, final_block_channels = 32, 1280
    layers = [1, 2, 3, 4, 3, 3, 1]
    downsample = [0, 1, 1, 1, 0, 1, 0]
    channels_per_layers = [16, 24, 32, 64, 96, 160, 320]
    channels: list = [[]]
    for ci, li, di in zip(channels_per_layers, layers, downsample):
        if di != 0:
            channels.append([ci] * li)
        else:
            channels[-1] = channels[-1] + [ci] * li
    channels = [c for c in channels if c]
    if width_scale != 1.0:
        channels = [[int(c * width_scale) for c in ci] for ci in channels]
        init_block_channels = int(init_block_channels * width_scale)
        if width_scale > 1.0:
            final_block_channels = int(final_block_channels * width_scale)
    return mobilenetv2(channels, init_block_channels, final_block_channels,
                       remove_exp_conv, **kwargs)


def _register(name: str, **cfg):
    def ctor(**kwargs):
        return get_mobilenetv2(**cfg, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _suffix, _scale in (("w1", 1.0), ("w3d4", 0.75), ("wd2", 0.5),
                        ("wd4", 0.25)):
    _register(f"mobilenetv2_{_suffix}", width_scale=_scale)
    _register(f"mobilenetv2b_{_suffix}", width_scale=_scale,
              remove_exp_conv=True)
