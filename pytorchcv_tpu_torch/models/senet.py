"""SENet for ImageNet-1K (NCHW). Counterpart of ``pytorchcv_tpu.models.
senet``: the same 6 registered names and ``get_senet`` table, the deep
stem ``SEInitBlock`` (also DANet's backbone stem), grouped bottlenecks
whose first 1x1 is half the group width, 3x3 identity convs from stage 2
on, and the classifier nested as ``output.fc`` behind a dropout."""

from __future__ import annotations

from torch import nn

from ..nn import SEBlock, conv1x1_block, conv3x3_block
from .registry import register_model
from .resnet import classifier
from .resnext import group_width, stage_channels

__all__ = ["SEInitBlock", "SENetBottleneck", "SENetUnit", "SENetOutput",
           "SENet", "get_senet"]


class SEInitBlock(nn.Module):
    """3x3/2 conv block to ``out_channels // 2``, 3x3 conv block, 3x3 conv
    block to ``out_channels``, then a 3x3/2 max-pool (reference
    senet.py:126)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        mid = out_channels // 2
        self.conv1 = conv3x3_block(in_channels, mid, stride=2)
        self.conv2 = conv3x3_block(mid, mid)
        self.conv3 = conv3x3_block(mid, out_channels)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x):
        return self.pool(self.conv3(self.conv2(self.conv1(x))))


class SENetBottleneck(nn.Module):
    """1x1 to half the group width -> grouped 3x3 to the group width (the
    stride) -> 1x1 (JAX ``models/senet.py:22``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 cardinality: int, bottleneck_width: int):
        super().__init__()
        gw = group_width(out_channels, cardinality, bottleneck_width)
        self.conv1 = conv1x1_block(in_channels, gw // 2)
        self.conv2 = conv3x3_block(gw // 2, gw, stride=stride,
                                   groups=cardinality)
        self.conv3 = conv1x1_block(gw, out_channels, activation=False)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class SENetUnit(nn.Module):
    """body, SE gate, + identity (a 1x1 conv block when the shape changes,
    3x3 with ``identity_conv3x3``), then ReLU (JAX ``models/senet.py:46``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 cardinality: int, bottleneck_width: int,
                 identity_conv3x3: bool):
        super().__init__()
        self.body = SENetBottleneck(in_channels, out_channels, stride,
                                    cardinality, bottleneck_width)
        self.se = SEBlock(out_channels)
        if in_channels != out_channels or stride != 1:
            block = conv3x3_block if identity_conv3x3 else conv1x1_block
            self.identity_conv = block(in_channels, out_channels,
                                       stride=stride, activation=False)
        else:
            self.identity_conv = None
        self.activ = nn.ReLU()

    def forward(self, x):
        identity = x if self.identity_conv is None else self.identity_conv(x)
        return self.activ(self.se(self.body(x)) + identity)


class SENetOutput(nn.Module):
    """Dropout (0.2, training only) + ``fc`` (JAX ``models/senet.py:92``)."""

    def __init__(self, in_features: int, num_classes: int,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.dropout = nn.Dropout(p=dropout_rate)
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x):
        return self.fc(self.dropout(x))


def SENet(channels, init_block_channels: int, cardinality: int,
          bottleneck_width: int, **kwargs):
    """SENet (JAX ``models/senet.py:107``): 3x3 identity convs from the
    second stage on."""
    def unit(c_in, c_out, stride, stage):
        return SENetUnit(c_in, c_out, stride, cardinality, bottleneck_width,
                         identity_conv3x3=stage != 0)
    return classifier(channels, init_block_channels, unit,
                      init_block=SEInitBlock, output=SENetOutput, **kwargs)


_TABLE = {16: ([1, 1, 1, 1], 32), 28: ([2, 2, 2, 2], 32),
          40: ([3, 3, 3, 3], 32), 52: ([3, 4, 6, 3], 32),
          103: ([3, 4, 23, 3], 32), 154: ([3, 8, 36, 3], 64)}


def get_senet(blocks: int, **kwargs):
    """Configuration expander (JAX ``models/senet.py:131``)."""
    if blocks not in _TABLE:
        raise ValueError(f"Unsupported SENet blocks: {blocks}")
    layers, cardinality = _TABLE[blocks]
    return SENet(stage_channels(layers), 128, cardinality, 4, **kwargs)


def _register(name: str, blocks: int):
    def ctor(**kwargs):
        return get_senet(blocks, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _blocks in {"senet16": 16, "senet28": 28, "senet40": 40,
                       "senet52": 52, "senet103": 103,
                       "senet154": 154}.items():
    _register(_name, _blocks)
