"""SE-ResNet for ImageNet-1K (NCHW): ResNet units with a squeeze-and-
excitation gate between the body and the residual add. Counterpart of
``pytorchcv_tpu.models.seresnet``: the same 17 registered names and the
same ``get_seresnet`` configuration table."""

from __future__ import annotations

from typing import Optional

from torch import nn

from ..nn import SEBlock, conv1x1_block
from .registry import register_model
from .resnet import _LAYERS, ResBlock, ResBottleneck, classifier

__all__ = ["SEResUnit", "SEResNet", "get_seresnet"]


class SEResUnit(nn.Module):
    """body (bottleneck or two 3x3s), SE gate, + identity (a 1x1 conv block
    when the shape changes), then ReLU (JAX ``models/seresnet.py:21``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bottleneck: bool, conv1_stride: bool):
        super().__init__()
        if bottleneck:
            self.body = ResBottleneck(in_channels, out_channels, stride,
                                      conv1_stride)
        else:
            self.body = ResBlock(in_channels, out_channels, stride)
        self.se = SEBlock(out_channels)
        if in_channels != out_channels or stride != 1:
            self.identity_conv = conv1x1_block(in_channels, out_channels,
                                               stride=stride,
                                               activation=False)
        else:
            self.identity_conv = None
        self.activ = nn.ReLU()

    def forward(self, x):
        identity = x if self.identity_conv is None else self.identity_conv(x)
        return self.activ(self.se(self.body(x)) + identity)


def SEResNet(channels, init_block_channels: int, bottleneck: bool,
             conv1_stride: bool, **kwargs):
    """SE-ResNet (JAX ``models/seresnet.py:51``)."""
    def unit(c_in, c_out, stride, _stage):
        return SEResUnit(c_in, c_out, stride, bottleneck, conv1_stride)
    return classifier(channels, init_block_channels, unit, **kwargs)


def get_seresnet(blocks: int, bottleneck: Optional[bool] = None,
                 conv1_stride: bool = True, **kwargs):
    """Configuration expander (JAX ``models/seresnet.py:86``)."""
    if bottleneck is None:
        bottleneck = blocks >= 50
    key = (blocks, bool(bottleneck))
    if key not in _LAYERS:
        raise ValueError(f"Unsupported SE-ResNet blocks: {blocks}")
    per_layer = [64, 128, 256, 512]
    if bottleneck:
        per_layer = [c * 4 for c in per_layer]
    channels = [[c] * n for c, n in zip(per_layer, _LAYERS[key])]
    return SEResNet(channels, 64, bottleneck, conv1_stride, **kwargs)


def _register(name: str, **fixed):
    def ctor(**kwargs):
        return get_seresnet(**fixed, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _cfg in {
        "seresnet10": dict(blocks=10), "seresnet12": dict(blocks=12),
        "seresnet14": dict(blocks=14), "seresnet16": dict(blocks=16),
        "seresnet18": dict(blocks=18),
        "seresnet26": dict(blocks=26, bottleneck=False),
        "seresnetbc26b": dict(blocks=26, bottleneck=True,
                              conv1_stride=False),
        "seresnet34": dict(blocks=34),
        "seresnetbc38b": dict(blocks=38, bottleneck=True,
                              conv1_stride=False),
        "seresnet50": dict(blocks=50),
        "seresnet50b": dict(blocks=50, conv1_stride=False),
        "seresnet101": dict(blocks=101),
        "seresnet101b": dict(blocks=101, conv1_stride=False),
        "seresnet152": dict(blocks=152),
        "seresnet152b": dict(blocks=152, conv1_stride=False),
        "seresnet200": dict(blocks=200),
        "seresnet200b": dict(blocks=200, conv1_stride=False)}.items():
    _register(_name, **_cfg)
