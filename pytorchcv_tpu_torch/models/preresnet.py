"""PreResNet (pre-activation ResNet) for ImageNet-1K (NCHW). Counterpart of
``pytorchcv_tpu.models.preresnet``: the same 22 registered names and
``get_preresnet`` configuration table, ``width_scale`` included. Every
conv is preceded by BN and ReLU (``PreConvBlock``); a unit adds its body
to the stream, or to a bare 1x1 conv of the body's pre-activated input
where the shape changes; ``post_activ`` (BN + ReLU) ends the trunk."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn import (NormActivation, Sequential, pre_conv1x1_block,
                  pre_conv3x3_block)
from ..nn.norm import BN_EPS
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["PreResBlock", "PreResBottleneck", "PreResUnit", "PreResInitBlock",
           "PreResActivation", "PreResNet", "get_preresnet",
           "preresnet_features", "preresnet_channels"]


class PreResBlock(nn.Module):
    """Two pre-activation 3x3 blocks; returns the body's output and the
    first block's pre-activated input (JAX ``models/preresnet.py:27``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bias: bool = False, use_bn: bool = True):
        super().__init__()
        self.conv1 = pre_conv3x3_block(in_channels, out_channels,
                                       stride=stride, bias=bias,
                                       use_bn=use_bn, return_preact=True)
        self.conv2 = pre_conv3x3_block(out_channels, out_channels, bias=bias,
                                       use_bn=use_bn)

    def forward(self, x):
        x, pre = self.conv1(x)
        return self.conv2(x), pre


class PreResBottleneck(nn.Module):
    """Pre-activation 1x1 down, 3x3, 1x1 up; the stride on conv1 when
    ``conv1_stride``, else on conv2 (JAX ``models/preresnet.py:48``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 conv1_stride: bool):
        super().__init__()
        mid = out_channels // 4
        self.conv1_stride = conv1_stride
        self.conv1 = pre_conv1x1_block(in_channels, mid,
                                       stride=stride if conv1_stride else 1,
                                       return_preact=True)
        self.conv2 = pre_conv3x3_block(mid, mid,
                                       stride=1 if conv1_stride else stride)
        self.conv3 = pre_conv1x1_block(mid, out_channels)

    def forward(self, x):
        x, pre = self.conv1(x)
        return self.conv3(self.conv2(x)), pre


def identity_conv(in_channels: int, out_channels: int, stride: int,
                  bias: bool = False) -> Optional[nn.Conv2d]:
    """The bare 1x1 conv of the pre-activated input where a unit changes
    the shape, else None."""
    if in_channels == out_channels and stride == 1:
        return None
    return nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=bias)


class PreResUnit(nn.Module):
    """body + identity (JAX ``models/preresnet.py:70``). The identity is
    the unit's input, or ``identity_conv`` of the body's pre-activated
    input. Without BN the reference's in-place ReLU has already turned the
    input into relu(x) when it is added, so the identity is relu(x)
    there (JAX ``:85-89``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bottleneck: bool, conv1_stride: bool, bias: bool = False,
                 use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        if bottleneck:
            self.body = PreResBottleneck(in_channels, out_channels, stride,
                                         conv1_stride)
        else:
            self.body = PreResBlock(in_channels, out_channels, stride,
                                    bias=bias, use_bn=use_bn)
        self.identity_conv = identity_conv(in_channels, out_channels, stride,
                                           bias)

    def forward(self, x):
        identity = x if self.use_bn else torch.relu(x)
        x, pre = self.body(x)
        if self.identity_conv is not None:
            identity = self.identity_conv(pre)
        return x + identity


class PreResInitBlock(nn.Module):
    """Plain 7x7/2 conv, BN, ReLU, 3x3/2 max-pool (JAX
    ``models/preresnet.py:106``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 7, stride=2,
                              padding=3, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS)
        self.activ = nn.ReLU()
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x):
        return self.pool(self.activ(self.bn(self.conv(x))))


class PreResActivation(NormActivation):
    """The final BN + ReLU (JAX ``models/preresnet.py:121``)."""


def preresnet_features(channels: Sequence[Sequence[int]],
                       init_block_channels: int, unit, in_channels: int = 3,
                       final_pool: bool = True) -> nn.Sequential:
    """``init_block``, ``stage1..`` of ``unit(c_in, c_out, stride)``
    (stride 2 at the first unit of every stage but the first),
    ``post_activ`` and, with ``final_pool``, the global average pool (JAX
    ``models/preresnet.py:125``)."""
    layers = [("init_block", PreResInitBlock(in_channels,
                                             init_block_channels))]
    c_in = init_block_channels
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            stride = 2 if j == 0 and i != 0 else 1
            units.append((f"unit{j + 1}", unit(c_in, c_out, stride)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    layers.append(("post_activ", PreResActivation(c_in)))
    if final_pool:
        layers.append(("final_pool", nn.AdaptiveAvgPool2d(1)))
    return Sequential(layers)


def PreResNet(channels: Sequence[Sequence[int]], init_block_channels: int,
              bottleneck: bool, conv1_stride: bool, in_channels: int = 3,
              in_size: Tuple[int, int] = (224, 224),
              num_classes: int = 1000) -> ImageClassifier:
    """PreResNet (JAX ``models/preresnet.py:146``)."""
    def unit(c_in, c_out, stride):
        return PreResUnit(c_in, c_out, stride, bottleneck, conv1_stride)
    features = preresnet_features(channels, init_block_channels, unit,
                                  in_channels)
    return ImageClassifier(features,
                           nn.Linear(channels[-1][-1], num_classes),
                           in_size=in_size, in_channels=in_channels,
                           num_classes=num_classes)


_LAYERS = {
    (10, False): [1, 1, 1, 1], (12, False): [2, 1, 1, 1],
    (14, False): [2, 2, 1, 1], (14, True): [1, 1, 1, 1],
    (16, False): [2, 2, 2, 1], (18, False): [2, 2, 2, 2],
    (26, False): [3, 3, 3, 3], (26, True): [2, 2, 2, 2],
    (34, False): [3, 4, 6, 3], (38, True): [3, 3, 3, 3],
    (50, True): [3, 4, 6, 3], (101, True): [3, 4, 23, 3],
    (152, True): [3, 8, 36, 3], (200, True): [3, 24, 36, 3],
    (269, True): [3, 30, 48, 8],
}


def preresnet_channels(blocks: int, bottleneck: Optional[bool],
                       width_scale: float = 1.0):
    """(channels per stage, init block channels, bottleneck) of a depth
    (JAX ``get_preresnet``, ``models/preresnet.py:178``): with
    ``width_scale`` every unit but the very last and the stem are
    narrowed."""
    if bottleneck is None:
        bottleneck = blocks >= 50
    key = (blocks, bool(bottleneck))
    if key not in _LAYERS:
        raise ValueError(f"Unsupported PreResNet blocks={blocks}")
    init_block_channels = 64
    per_layer = [64, 128, 256, 512]
    if bottleneck:
        per_layer = [c * 4 for c in per_layer]
    channels = [[c] * n for c, n in zip(per_layer, _LAYERS[key])]
    if width_scale != 1.0:
        channels = [[int(c * width_scale)
                     if i != len(channels) - 1 or j != len(cs) - 1 else c
                     for j, c in enumerate(cs)]
                    for i, cs in enumerate(channels)]
        init_block_channels = int(init_block_channels * width_scale)
    return channels, init_block_channels, bool(bottleneck)


def get_preresnet(blocks: int, bottleneck: Optional[bool] = None,
                  conv1_stride: bool = True, width_scale: float = 1.0,
                  **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/preresnet.py:178``)."""
    channels, init, bottleneck = preresnet_channels(blocks, bottleneck,
                                                    width_scale)
    return PreResNet(channels, init, bottleneck, conv1_stride, **kwargs)


def _register(name: str, **fixed):
    def ctor(**kwargs):
        return get_preresnet(**fixed, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _cfg in {
        "preresnet10": dict(blocks=10), "preresnet12": dict(blocks=12),
        "preresnet14": dict(blocks=14),
        "preresnetbc14b": dict(blocks=14, bottleneck=True,
                               conv1_stride=False),
        "preresnet16": dict(blocks=16),
        "preresnet18_wd4": dict(blocks=18, width_scale=0.25),
        "preresnet18_wd2": dict(blocks=18, width_scale=0.5),
        "preresnet18_w3d4": dict(blocks=18, width_scale=0.75),
        "preresnet18": dict(blocks=18),
        "preresnet26": dict(blocks=26, bottleneck=False),
        "preresnetbc26b": dict(blocks=26, bottleneck=True,
                               conv1_stride=False),
        "preresnet34": dict(blocks=34),
        "preresnetbc38b": dict(blocks=38, bottleneck=True,
                               conv1_stride=False),
        "preresnet50": dict(blocks=50),
        "preresnet50b": dict(blocks=50, conv1_stride=False),
        "preresnet101": dict(blocks=101),
        "preresnet101b": dict(blocks=101, conv1_stride=False),
        "preresnet152": dict(blocks=152),
        "preresnet152b": dict(blocks=152, conv1_stride=False),
        "preresnet200": dict(blocks=200),
        "preresnet200b": dict(blocks=200, conv1_stride=False),
        "preresnet269b": dict(blocks=269, conv1_stride=False)}.items():
    _register(_name, **_cfg)
