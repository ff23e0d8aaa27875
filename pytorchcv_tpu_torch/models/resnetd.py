"""ResNet(D): the dilated ResNet trunk of the segmentation models
(counterpart of ``pytorchcv_tpu.models.resnetd``; reference resnetd.py).
SENet deep stem (init channels doubled); stride 2 only at the first unit of
stage 2, stages 3 and 4 dilated."""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import MultiOutputSequential, Sequential
from .registry import register_model
from .resnet import ResUnit
from .senet import SEInitBlock

__all__ = ["ResNetD", "resnetd_features", "get_resnetd"]

_LAYERS = {10: [1, 1, 1, 1], 12: [2, 1, 1, 1], 14: [2, 2, 1, 1],
           16: [2, 2, 2, 1], 18: [2, 2, 2, 2], 34: [3, 4, 6, 3],
           50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
           200: [3, 24, 36, 3]}


def resnetd_features(channels: Sequence[Sequence[int]],
                     init_block_channels: int, bottleneck: bool,
                     conv1_stride: bool, bends: Sequence[int] = (),
                     final_pool: bool = True,
                     in_channels: int = 3) -> MultiOutputSequential:
    """The trunk: ``init_block`` (``2 * init_block_channels`` wide),
    ``stage1..4`` (unit ``j`` of stage ``i``, both 0-based, has dilation
    ``2 ** max(0, i - 1 - (j == 0))``) and an optional global average
    pool; returns ``[last, *outputs of the bends stages]``."""
    c_in = 2 * init_block_channels
    layers = [("init_block", SEInitBlock(in_channels, c_in))]
    output_idx = []
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            stride = 2 if j == 0 and i == 1 else 1
            dilation = 2 ** max(0, i - 1 - int(j == 0))
            units.append((f"unit{j + 1}", ResUnit(
                c_in, c_out, stride, bottleneck, conv1_stride,
                padding=dilation, dilation=dilation)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
        if (i + 1) in tuple(bends):
            output_idx.append(len(layers) - 1)
    if final_pool:
        layers.append(("final_pool", nn.AdaptiveAvgPool2d(1)))
    return MultiOutputSequential(layers, output_idx)


class ResNetD(nn.Module):
    """Classifier over the ResNet(D) trunk."""

    def __init__(self, features: MultiOutputSequential, output: nn.Module,
                 in_size: Tuple[int, int] = (224, 224), in_channels: int = 3,
                 num_classes: int = 1000):
        super().__init__()
        self.features = features
        self.output = output
        self.in_size = tuple(in_size)
        self.in_channels = in_channels
        self.num_classes = num_classes

    def forward(self, x):
        return self.output(self.features(x)[0].flatten(1))


def get_resnetd(blocks: int, conv1_stride: bool = True, in_channels: int = 3,
                in_size: Tuple[int, int] = (224, 224),
                num_classes: int = 1000) -> ResNetD:
    """Configuration expander (reference resnetd.py:110)."""
    if blocks not in _LAYERS:
        raise ValueError(f"Unsupported ResNet(D) blocks: {blocks}")
    bottleneck = blocks >= 50
    per_layer = [64, 128, 256, 512]
    if bottleneck:
        per_layer = [c * 4 for c in per_layer]
    channels = [[c] * n for c, n in zip(per_layer, _LAYERS[blocks])]
    features = resnetd_features(channels, 64, bottleneck, conv1_stride,
                                in_channels=in_channels)
    return ResNetD(features, nn.Linear(channels[-1][-1], num_classes),
                   in_size=in_size, in_channels=in_channels,
                   num_classes=num_classes)


def _register(name: str, **fixed):
    def ctor(**kwargs):
        return get_resnetd(**fixed, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _blocks in (("resnetd50b", 50), ("resnetd101b", 101),
                       ("resnetd152b", 152)):
    _register(_name, blocks=_blocks, conv1_stride=False)
