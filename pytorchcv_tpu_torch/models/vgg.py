"""VGG for ImageNet-1K (NCHW). Counterpart of ``pytorchcv_tpu.models.vgg``:
the same 12 registered names (bias-ful 3x3 conv stacks, with BN in the
``bn_vgg*`` variants, a 2x2/s2 max-pool after each stage, and the
4096-wide fc head with dropout)."""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import Sequential, conv3x3_block
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["VGGDense", "VGGOutputBlock", "VGG", "get_vgg"]


class VGGDense(nn.Module):
    """fc -> ReLU -> dropout (JAX ``models/vgg.py:20``)."""

    def __init__(self, in_features: int, out_features: int = 4096):
        super().__init__()
        self.fc = nn.Linear(in_features, out_features)
        self.activ = nn.ReLU()
        self.dropout = nn.Dropout(p=0.5)

    def forward(self, x):
        return self.dropout(self.activ(self.fc(x)))


class VGGOutputBlock(nn.Module):
    """fc1 -> fc2 -> fc3 (JAX ``models/vgg.py:36``)."""

    def __init__(self, in_features: int, classes: int = 1000):
        super().__init__()
        self.fc1 = VGGDense(in_features)
        self.fc2 = VGGDense(4096)
        self.fc3 = nn.Linear(4096, classes)

    def forward(self, x):
        return self.fc3(self.fc2(self.fc1(x)))


def VGG(channels: Sequence[Sequence[int]], bias: bool = True,
        use_bn: bool = False, in_channels: int = 3,
        in_size: Tuple[int, int] = (224, 224),
        num_classes: int = 1000) -> ImageClassifier:
    """VGG (JAX ``models/vgg.py:50``). fc1 reads the last stage's map
    flattened in NCHW order, (H / 32) x (W / 32) pixels of its channels."""
    stages = []
    c_in = in_channels
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            units.append((f"unit{j + 1}", conv3x3_block(
                c_in, c_out, bias=bias, normalization=use_bn)))
            c_in = c_out
        units.append(("pool", nn.MaxPool2d(2, stride=2, padding=0)))
        stages.append((f"stage{i + 1}", Sequential(units)))
    in_features = c_in * (in_size[0] // 32) * (in_size[1] // 32)
    return ImageClassifier(Sequential(stages),
                           VGGOutputBlock(in_features, num_classes),
                           in_size=in_size, in_channels=in_channels,
                           num_classes=num_classes)


def get_vgg(blocks: int, bias: bool = True, use_bn: bool = False,
            **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/vgg.py:70``)."""
    layers_table = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
                    16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}
    if blocks not in layers_table:
        raise ValueError(f"Unsupported VGG blocks: {blocks}")
    per_layer = [64, 128, 256, 512, 512]
    channels = [[c] * n for c, n in zip(per_layer, layers_table[blocks])]
    return VGG(channels, bias=bias, use_bn=use_bn, **kwargs)


def _register(name: str, **fixed):
    def ctor(**kwargs):
        return get_vgg(**fixed, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _cfg in {
        "vgg11": dict(blocks=11), "vgg13": dict(blocks=13),
        "vgg16": dict(blocks=16), "vgg19": dict(blocks=19),
        "bn_vgg11": dict(blocks=11, bias=False, use_bn=True),
        "bn_vgg13": dict(blocks=13, bias=False, use_bn=True),
        "bn_vgg16": dict(blocks=16, bias=False, use_bn=True),
        "bn_vgg19": dict(blocks=19, bias=False, use_bn=True),
        "bn_vgg11b": dict(blocks=11, bias=True, use_bn=True),
        "bn_vgg13b": dict(blocks=13, bias=True, use_bn=True),
        "bn_vgg16b": dict(blocks=16, bias=True, use_bn=True),
        "bn_vgg19b": dict(blocks=19, bias=True, use_bn=True)}.items():
    _register(_name, **_cfg)
