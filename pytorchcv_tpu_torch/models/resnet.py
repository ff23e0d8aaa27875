"""ResNet for ImageNet-1K (NCHW), with the reference pytorchcv module names
(``features.stage1.unit1.body.conv1.conv.weight``, ...). Counterpart of
``pytorchcv_tpu.models.resnet``: the same 21 registered names and the same
``get_resnet`` configuration table."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from torch import nn

from ..nn import Sequential, conv1x1_block, conv3x3_block, conv7x7_block
from ..nn.activ import Activation, create_activation
from ..nn.conv import Normalization
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["ResBlock", "ResBottleneck", "ResUnit", "ResInitBlock",
           "classifier", "get_resnet", "resnet_stages", "resnet_features"]


class ResBlock(nn.Module):
    """Two 3x3 conv blocks; ``final_activation`` (none by default) after
    the second. ProPainter's take ``bias``, no BN and LeakyReLU, RAFT's
    encoder ``bias``, instance norm or none and a final ReLU (JAX
    ``models/resnet.py:32``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bias: bool = False, normalization: Normalization = True,
                 activation: Activation = True,
                 final_activation: Activation = False):
        super().__init__()
        cell = dict(bias=bias, normalization=normalization)
        self.conv1 = conv3x3_block(in_channels, out_channels, stride=stride,
                                   activation=activation, **cell)
        self.conv2 = conv3x3_block(out_channels, out_channels,
                                   activation=final_activation, **cell)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class ResBottleneck(nn.Module):
    """1x1 down, 3x3, 1x1 up, ``final_activation`` (none by default) after
    the last. The stride sits on conv1 when ``conv1_stride`` (pytorchcv
    resnet50), else on conv2 (resnet50b); the 3x3 takes ``padding`` and
    ``dilation`` (the dilated ResNet(D)); ``bias`` and ``normalization``
    reach all three (JAX ``models/resnet.py:55``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 conv1_stride: bool, bottleneck_factor: int = 4,
                 padding: int = 1, dilation: int = 1, bias: bool = False,
                 normalization: Normalization = True,
                 activation: Activation = True,
                 final_activation: Activation = False):
        super().__init__()
        mid = out_channels // bottleneck_factor
        cell = dict(bias=bias, normalization=normalization)
        self.conv1_stride = conv1_stride
        self.conv1 = conv1x1_block(in_channels, mid,
                                   stride=stride if conv1_stride else 1,
                                   activation=activation, **cell)
        self.conv2 = conv3x3_block(mid, mid,
                                   stride=1 if conv1_stride else stride,
                                   padding=padding, dilation=dilation,
                                   activation=activation, **cell)
        self.conv3 = conv1x1_block(mid, out_channels,
                                   activation=final_activation, **cell)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class ResUnit(nn.Module):
    """body + identity (a 1x1 conv block when the shape changes) +
    ``final_activation`` (ReLU by default). Both bodies take ``bias``,
    ``normalization`` (True BN, a factory of channels, or None),
    ``activation`` and ``final_body_activation``, the activation of the
    body's last conv before the add (JAX ``models/resnet.py:90``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bottleneck: bool, conv1_stride: bool, padding: int = 1,
                 dilation: int = 1, bias: bool = False,
                 normalization: Normalization = True,
                 activation: Activation = True,
                 final_body_activation: Activation = False,
                 final_activation: Activation = True):
        super().__init__()
        cell = dict(bias=bias, normalization=normalization,
                    activation=activation,
                    final_activation=final_body_activation)
        if bottleneck:
            self.body = ResBottleneck(in_channels, out_channels, stride,
                                      conv1_stride, padding=padding,
                                      dilation=dilation, **cell)
        else:
            self.body = ResBlock(in_channels, out_channels, stride, **cell)
        if in_channels != out_channels or stride != 1:
            self.identity_conv = conv1x1_block(
                in_channels, out_channels, stride=stride, bias=bias,
                normalization=normalization, activation=False)
        else:
            self.identity_conv = None
        self.activ = create_activation(final_activation)

    def forward(self, x):
        identity = x if self.identity_conv is None else self.identity_conv(x)
        x = self.body(x) + identity
        return x if self.activ is None else self.activ(x)


class ResInitBlock(nn.Module):
    """7x7/2 conv block + 3x3/2 max-pool."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = conv7x7_block(in_channels, out_channels, stride=2)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x):
        return self.pool(self.conv(x))


def resnet_stages(channels: Sequence[Sequence[int]], init_block: nn.Module,
                  c_in: int, unit, final_pool: bool = True) -> nn.Sequential:
    """``init_block`` (``c_in`` wide), then ``stage1..``: unit j of stage i
    (both 0-based) is ``unit(c_in, c_out, stride, i, j)``, stride 2 at the
    first unit of every stage but the first; with ``final_pool`` the
    global average pool (the reference's AvgPool2d(7) at 224 input, and
    shape-robust otherwise)."""
    layers = [("init_block", init_block)]
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            stride = 2 if j == 0 and i != 0 else 1
            units.append((f"unit{j + 1}", unit(c_in, c_out, stride, i, j)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    if final_pool:
        layers.append(("final_pool", nn.AdaptiveAvgPool2d(1)))
    return Sequential(layers)


def classifier(channels: Sequence[Sequence[int]], init_block_channels: int,
               unit, in_channels: int = 3,
               in_size: Tuple[int, int] = (224, 224), num_classes: int = 1000,
               init_block=ResInitBlock, output=None) -> ImageClassifier:
    """The residual classifier: ``init_block``, stages of ``unit(c_in,
    c_out, stride, stage index)`` (``resnet_stages``), global average
    pool, ``output(c_in, classes)`` (default ``nn.Linear``). ResNet,
    SE-ResNet, ResNeXt, SE-ResNeXt and SENet build on it."""
    features = resnet_stages(
        channels, init_block(in_channels, init_block_channels),
        init_block_channels,
        lambda c_in, c_out, stride, i, _j: unit(c_in, c_out, stride, i))
    c_in = channels[-1][-1]
    head = nn.Linear(c_in, num_classes) if output is None else \
        output(c_in, num_classes)
    return ImageClassifier(features, head, in_size=in_size,
                           in_channels=in_channels, num_classes=num_classes)


def resnet_features(channels: Sequence[Sequence[int]],
                    init_block_channels: int, bottleneck: bool,
                    conv1_stride: bool, final_pool: bool = True,
                    in_channels: int = 3) -> nn.Sequential:
    """The ResNet trunk (JAX ``models/resnet.py:154``): ``init_block`` and
    ``stage1..4`` of ``ResUnit`` (``resnet_stages``), with ``final_pool``
    the global average pool. SimplePose and CenterNet take it without the
    pool, its children renamed "0".."4"."""
    return resnet_stages(
        channels, ResInitBlock(in_channels, init_block_channels),
        init_block_channels,
        lambda c_in, c_out, stride, _i, _j: ResUnit(
            c_in, c_out, stride, bottleneck, conv1_stride), final_pool)


def resnet(channels: Sequence[Sequence[int]], init_block_channels: int,
           bottleneck: bool, conv1_stride: bool,
           **kwargs) -> ImageClassifier:
    def unit(c_in, c_out, stride, _stage):
        return ResUnit(c_in, c_out, stride, bottleneck, conv1_stride)
    return classifier(channels, init_block_channels, unit, **kwargs)


_LAYERS = {
    (10, False): [1, 1, 1, 1],
    (12, False): [2, 1, 1, 1],
    (14, False): [2, 2, 1, 1],
    (14, True): [1, 1, 1, 1],
    (16, False): [2, 2, 2, 1],
    (18, False): [2, 2, 2, 2],
    (26, False): [3, 3, 3, 3],
    (26, True): [2, 2, 2, 2],
    (34, False): [3, 4, 6, 3],
    (38, True): [3, 3, 3, 3],
    (50, True): [3, 4, 6, 3],
    (101, True): [3, 4, 23, 3],
    (152, True): [3, 8, 36, 3],
    (200, True): [3, 24, 36, 3],
}


def get_resnet(blocks: int, bottleneck: Optional[bool] = None,
               conv1_stride: bool = True, width_scale: float = 1.0,
               **kwargs) -> ImageClassifier:
    """Configuration expander: depth, bottleneck and width. With
    ``width_scale`` every unit but the very last is narrowed, as in the
    reference."""
    if bottleneck is None:
        bottleneck = blocks >= 50
    key = (blocks, bool(bottleneck))
    if key not in _LAYERS:
        raise ValueError(f"Unsupported ResNet with blocks={blocks}, "
                         f"bottleneck={bottleneck}")
    layers = _LAYERS[key]
    init_block_channels = 64
    per_layer = [64, 128, 256, 512]
    if bottleneck:
        per_layer = [c * 4 for c in per_layer]
    channels = [[c] * n for c, n in zip(per_layer, layers)]
    if width_scale != 1.0:
        channels = [[int(c * width_scale)
                     if i != len(channels) - 1 or j != len(cs) - 1 else c
                     for j, c in enumerate(cs)]
                    for i, cs in enumerate(channels)]
        init_block_channels = int(init_block_channels * width_scale)
    return resnet(channels, init_block_channels, bottleneck, conv1_stride,
                  **kwargs)


def _register(name: str, **fixed):
    def ctor(**kwargs):
        return get_resnet(**fixed, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _cfg in {
        "resnet10": dict(blocks=10),
        "resnet12": dict(blocks=12),
        "resnet14": dict(blocks=14),
        "resnetbc14b": dict(blocks=14, bottleneck=True, conv1_stride=False),
        "resnet16": dict(blocks=16),
        "resnet18_wd4": dict(blocks=18, width_scale=0.25),
        "resnet18_wd2": dict(blocks=18, width_scale=0.5),
        "resnet18_w3d4": dict(blocks=18, width_scale=0.75),
        "resnet18": dict(blocks=18),
        "resnet26": dict(blocks=26, bottleneck=False),
        "resnetbc26b": dict(blocks=26, bottleneck=True, conv1_stride=False),
        "resnet34": dict(blocks=34),
        "resnetbc38b": dict(blocks=38, bottleneck=True, conv1_stride=False),
        "resnet50": dict(blocks=50),
        "resnet50b": dict(blocks=50, conv1_stride=False),
        "resnet101": dict(blocks=101),
        "resnet101b": dict(blocks=101, conv1_stride=False),
        "resnet152": dict(blocks=152),
        "resnet152b": dict(blocks=152, conv1_stride=False),
        "resnet200": dict(blocks=200),
        "resnet200b": dict(blocks=200, conv1_stride=False)}.items():
    _register(_name, **_cfg)
