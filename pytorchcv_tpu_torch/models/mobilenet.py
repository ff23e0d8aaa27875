"""MobileNet (v1), its simplified B variant and FD-MobileNet, NCHW, with
the reference pytorchcv module names (``features.stage1.unit1.dw_conv.conv
.weight``, ...). Counterpart of ``pytorchcv_tpu.models.mobilenet``: the
same 12 registered names and channel plans.

The depthwise blocks with BN and ReLU run in eval mode as one K6 launch
each (``kernels.dwconv``, the bf16 route); the int8 route serves the model
through ``quant.mobilenet_int8`` (``mobilenet_*`` and ``fdmobilenet_*``;
``mobilenetb_*``, whose depthwise conv has no BN, is served in bf16).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import (Sequential, conv3x3_block, dwsconv3x3_block,
                  global_avg_pool2d)
from ..nn.activ import Activation
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["mobilenet", "get_mobilenet", "get_fdmobilenet"]


def mobilenet(channels: Sequence[Sequence[int]], first_stage_stride: bool,
              dw_use_bn: bool = True, dw_activation: Activation = True,
              in_channels: int = 3, in_size: Tuple[int, int] = (224, 224),
              num_classes: int = 1000) -> ImageClassifier:
    """MobileNet (JAX ``models/mobilenet.py:21``): a 3x3/s2 stem, stages of
    depthwise-separable units (the first unit of each stage strides, the
    first stage's only with ``first_stage_stride``), mean pool, dense
    head."""
    layers = [("init_block", conv3x3_block(in_channels, channels[0][0],
                                           stride=2))]
    c_in = channels[0][0]
    for i, stage_channels in enumerate(channels[1:]):
        units = []
        for j, c_out in enumerate(stage_channels):
            stride = 2 if j == 0 and (i != 0 or first_stage_stride) else 1
            units.append((f"unit{j + 1}", dwsconv3x3_block(
                c_in, c_out, stride=stride, dw_use_bn=dw_use_bn,
                dw_activation=dw_activation)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    layers.append(("final_pool", global_avg_pool2d()))
    return ImageClassifier(Sequential(layers), nn.Linear(c_in, num_classes),
                           in_size=in_size, in_channels=in_channels,
                           num_classes=num_classes)


def _scaled(channels, width_scale: float):
    if width_scale == 1.0:
        return channels
    return [[int(c * width_scale) for c in ci] for ci in channels]


def get_mobilenet(width_scale: float, dws_simplified: bool = False,
                  **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/mobilenet.py:46``); the B
    variant (``dws_simplified``) has no BN and no activation on its
    depthwise convs."""
    channels = [[32], [64], [128, 128], [256, 256],
                [512, 512, 512, 512, 512, 512], [1024, 1024]]
    return mobilenet(_scaled(channels, width_scale), first_stage_stride=False,
                     dw_use_bn=not dws_simplified,
                     dw_activation=None if dws_simplified else True,
                     **kwargs)


def get_fdmobilenet(width_scale: float, **kwargs) -> ImageClassifier:
    """FD-MobileNet: the fast-downsampling plan (JAX
    ``models/mobilenet.py:85``), its first stage strides."""
    channels = [[32], [64], [128, 128], [256, 256],
                [512, 512, 512, 512, 512, 1024]]
    return mobilenet(_scaled(channels, width_scale), first_stage_stride=True,
                     **kwargs)


def _register(name: str, build, **cfg):
    def ctor(**kwargs):
        return build(**cfg, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _suffix, _scale in (("w1", 1.0), ("w3d4", 0.75), ("wd2", 0.5),
                        ("wd4", 0.25)):
    _register(f"mobilenet_{_suffix}", get_mobilenet, width_scale=_scale)
    _register(f"mobilenetb_{_suffix}", get_mobilenet, width_scale=_scale,
              dws_simplified=True)
    _register(f"fdmobilenet_{_suffix}", get_fdmobilenet, width_scale=_scale)
