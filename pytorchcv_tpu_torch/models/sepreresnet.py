"""SE-PreResNet for ImageNet-1K (NCHW): PreResNet units with a squeeze-and-
excitation gate on the body before the add. Counterpart of
``pytorchcv_tpu.models.sepreresnet``: the same 17 registered names and
``get_sepreresnet`` configuration table."""

from __future__ import annotations

from typing import Optional

from torch import nn

from ..nn import SEBlock
from .preresnet import (PreResBlock, PreResBottleneck, identity_conv,
                        preresnet_channels, preresnet_features)
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["SEPreResUnit", "SEPreResNet", "get_sepreresnet"]


class SEPreResUnit(nn.Module):
    """body, SE gate, + identity (the unit's input, or a bare 1x1 conv of
    the body's pre-activated input) (JAX ``models/sepreresnet.py:21``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bottleneck: bool, conv1_stride: bool):
        super().__init__()
        if bottleneck:
            self.body = PreResBottleneck(in_channels, out_channels, stride,
                                         conv1_stride)
        else:
            self.body = PreResBlock(in_channels, out_channels, stride)
        self.se = SEBlock(out_channels)
        self.identity_conv = identity_conv(in_channels, out_channels, stride)

    def forward(self, x):
        identity = x
        x, pre = self.body(x)
        x = self.se(x)
        if self.identity_conv is not None:
            identity = self.identity_conv(pre)
        return x + identity


def SEPreResNet(channels, init_block_channels: int, bottleneck: bool,
                conv1_stride: bool, in_channels: int = 3, in_size=(224, 224),
                num_classes: int = 1000) -> ImageClassifier:
    """SE-PreResNet (JAX ``models/sepreresnet.py:50``)."""
    def unit(c_in, c_out, stride):
        return SEPreResUnit(c_in, c_out, stride, bottleneck, conv1_stride)
    features = preresnet_features(channels, init_block_channels, unit,
                                  in_channels)
    return ImageClassifier(features,
                           nn.Linear(channels[-1][-1], num_classes),
                           in_size=in_size, in_channels=in_channels,
                           num_classes=num_classes)


def get_sepreresnet(blocks: int, bottleneck: Optional[bool] = None,
                    conv1_stride: bool = True, **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/sepreresnet.py:86``)."""
    if blocks == 269:
        raise ValueError("Unsupported SE-PreResNet blocks: 269")
    channels, init, bottleneck = preresnet_channels(blocks, bottleneck)
    return SEPreResNet(channels, init, bottleneck, conv1_stride, **kwargs)


def _register(name: str, **fixed):
    def ctor(**kwargs):
        return get_sepreresnet(**fixed, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _cfg in {
        "sepreresnet10": dict(blocks=10), "sepreresnet12": dict(blocks=12),
        "sepreresnet14": dict(blocks=14), "sepreresnet16": dict(blocks=16),
        "sepreresnet18": dict(blocks=18),
        "sepreresnet26": dict(blocks=26, bottleneck=False),
        "sepreresnetbc26b": dict(blocks=26, bottleneck=True,
                                 conv1_stride=False),
        "sepreresnet34": dict(blocks=34),
        "sepreresnetbc38b": dict(blocks=38, bottleneck=True,
                                 conv1_stride=False),
        "sepreresnet50": dict(blocks=50),
        "sepreresnet50b": dict(blocks=50, conv1_stride=False),
        "sepreresnet101": dict(blocks=101),
        "sepreresnet101b": dict(blocks=101, conv1_stride=False),
        "sepreresnet152": dict(blocks=152),
        "sepreresnet152b": dict(blocks=152, conv1_stride=False),
        "sepreresnet200": dict(blocks=200),
        "sepreresnet200b": dict(blocks=200, conv1_stride=False)}.items():
    _register(_name, **_cfg)
