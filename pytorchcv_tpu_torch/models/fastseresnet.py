"""Fast-SE-ResNet (NCHW), with the reference pytorchcv module names.
Counterpart of ``pytorchcv_tpu.models.fastseresnet``: the trunk and the
``fastseresnet101b`` classifier. An SE gate (dense ``fc1``/``fc2``,
reduction 1) only on the first unit of each stage."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..nn import SEBlock, conv1x1_block
from .registry import register_model
from .resnet import ResBlock, ResBottleneck, ResInitBlock, resnet_stages
from .shell import ImageClassifier

__all__ = ["FastSEResUnit", "fastseresnet_features", "get_fastseresnet"]


class FastSEResUnit(nn.Module):
    """body, the optional SE gate, + identity (a 1x1 conv block when the
    shape changes), then ReLU (JAX ``models/fastseresnet.py:21``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bottleneck: bool, conv1_stride: bool, use_se: bool):
        super().__init__()
        if bottleneck:
            self.body = ResBottleneck(in_channels, out_channels, stride,
                                      conv1_stride)
        else:
            self.body = ResBlock(in_channels, out_channels, stride)
        self.se = SEBlock(out_channels, reduction=1, use_conv=False) \
            if use_se else None
        if in_channels != out_channels or stride != 1:
            self.identity_conv = conv1x1_block(in_channels, out_channels,
                                               stride=stride,
                                               activation=False)
        else:
            self.identity_conv = None
        self.activ = nn.ReLU()

    def forward(self, x):
        identity = x if self.identity_conv is None else self.identity_conv(x)
        x = self.body(x)
        if self.se is not None:
            x = self.se(x)
        return self.activ(x + identity)


def fastseresnet_features(channels: Sequence[Sequence[int]],
                          init_block_channels: int, bottleneck: bool,
                          conv1_stride: bool, final_pool: bool = True,
                          in_channels: int = 3) -> nn.Sequential:
    """``init_block`` (7x7/2 + max-pool), ``stage1..`` (``resnet_stages``;
    the SE gate on the first unit of every stage) and, with ``final_pool``,
    the global average pool (JAX ``models/fastseresnet.py:55``)."""
    return resnet_stages(
        channels, ResInitBlock(in_channels, init_block_channels),
        init_block_channels,
        lambda c_in, c_out, stride, _i, j: FastSEResUnit(
            c_in, c_out, stride, bottleneck, conv1_stride, j == 0),
        final_pool)


def get_fastseresnet(blocks: int, conv1_stride: bool = True,
                     in_channels: int = 3, **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/fastseresnet.py:88``)."""
    if blocks != 101:
        raise ValueError(f"Unsupported Fast-SE-ResNet blocks: {blocks}")
    channels = [[c] * n for c, n in zip([256, 512, 1024, 2048],
                                        [3, 4, 23, 3])]
    features = fastseresnet_features(channels, 64, True, conv1_stride,
                                     in_channels=in_channels)
    num_classes = kwargs.pop("num_classes", 1000)
    return ImageClassifier(features, nn.Linear(2048, num_classes),
                           in_channels=in_channels, num_classes=num_classes,
                           **kwargs)


@register_model("fastseresnet101b")
def fastseresnet101b(**kwargs) -> ImageClassifier:
    return get_fastseresnet(101, conv1_stride=False, **kwargs)
