"""SE-ResNeXt for ImageNet-1K (NCHW): ResNeXt units with a squeeze-and-
excitation gate between the body and the residual add. Counterpart of
``pytorchcv_tpu.models.seresnext``: the same 3 registered names."""

from __future__ import annotations

from torch import nn

from ..nn import SEBlock, conv1x1_block
from .registry import register_model
from .resnet import classifier
from .resnext import ResNeXtBottleneck, stage_channels

__all__ = ["SEResNeXtUnit", "SEResNeXt", "get_seresnext"]


class SEResNeXtUnit(nn.Module):
    """ResNeXt body, SE gate, + identity, then ReLU (JAX
    ``models/seresnext.py:20``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 cardinality: int, bottleneck_width: int):
        super().__init__()
        self.body = ResNeXtBottleneck(in_channels, out_channels, stride,
                                      cardinality, bottleneck_width)
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


def SEResNeXt(channels, init_block_channels: int, cardinality: int,
              bottleneck_width: int, **kwargs):
    """SE-ResNeXt (JAX ``models/seresnext.py:47``)."""
    def unit(c_in, c_out, stride, _stage):
        return SEResNeXtUnit(c_in, c_out, stride, cardinality,
                             bottleneck_width)
    return classifier(channels, init_block_channels, unit, **kwargs)


_LAYERS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


def get_seresnext(blocks: int, cardinality: int, bottleneck_width: int,
                  **kwargs):
    """Configuration expander (JAX ``models/seresnext.py:71``)."""
    if blocks not in _LAYERS:
        raise ValueError(f"Unsupported SE-ResNeXt blocks: {blocks}")
    return SEResNeXt(stage_channels(_LAYERS[blocks]), 64, cardinality,
                     bottleneck_width, **kwargs)


def _register(name: str, blocks: int, cardinality: int, width: int):
    def ctor(**kwargs):
        return get_seresnext(blocks, cardinality, width, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _cfg in {"seresnext50_32x4d": (50, 32, 4),
                    "seresnext101_32x4d": (101, 32, 4),
                    "seresnext101_64x4d": (101, 64, 4)}.items():
    _register(_name, *_cfg)
