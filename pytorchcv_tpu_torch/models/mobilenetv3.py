"""MobileNetV3 (small and large), NCHW, with the reference pytorchcv module
names (``features.stage3.unit1.se.conv1.weight``, ...). Counterpart of
``pytorchcv_tpu.models.mobilenetv3``: the same 10 registered names and
configuration table.

Served in bf16 (the JAX package declares its int8 pipeline only on
request): the depthwise blocks (BN, ReLU or hswish, 3x3 or 5x5, stride 1
or 2) run in eval mode as one K6 launch each (``kernels.dwconv``; hswish
as K6's dividing code, ``hswish_div``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import (HSwish, SEBlock, Sequential, conv1x1, conv1x1_block,
                  conv3x3_block, dwconv3x3_block, dwconv5x5_block,
                  global_avg_pool2d, lambda_hsigmoid, lambda_hswish,
                  lambda_relu, round_channels)
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["MobileNetV3Unit", "MobileNetV3FinalBlock",
           "MobileNetV3Classifier", "mobilenetv3", "get_mobilenetv3"]


def _se(channels: int) -> SEBlock:
    return SEBlock(channels, reduction=4, round_mid=True,
                   out_activation=lambda_hsigmoid())


class MobileNetV3Unit(nn.Module):
    """1x1 expansion (where the widths differ) -> depthwise 3x3 or 5x5 ->
    [SE with hard-sigmoid] -> linear 1x1 projection, residual where the
    shape holds (JAX ``models/mobilenetv3.py:24``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 exp_channels: int, stride: int, use_kernel3: bool,
                 activation, use_se: bool):
        super().__init__()
        self.residual = in_channels == out_channels and stride == 1
        self.exp_conv = conv1x1_block(in_channels, exp_channels,
                                      activation=activation) \
            if exp_channels != out_channels else None
        dw = dwconv3x3_block if use_kernel3 else dwconv5x5_block
        self.conv1 = dw(exp_channels, exp_channels, stride=stride,
                        activation=activation)
        self.se = _se(exp_channels) if use_se else None
        self.conv2 = conv1x1_block(exp_channels, out_channels,
                                   activation=None)

    def forward(self, x):
        identity = x
        if self.exp_conv is not None:
            x = self.exp_conv(x)
        x = self.conv1(x)
        if self.se is not None:
            x = self.se(x)
        x = self.conv2(x)
        return x + identity if self.residual else x


class MobileNetV3FinalBlock(nn.Module):
    """1x1 conv block with hswish, then [SE] (JAX
    ``models/mobilenetv3.py:59``)."""

    def __init__(self, in_channels: int, out_channels: int, use_se: bool):
        super().__init__()
        self.conv = conv1x1_block(in_channels, out_channels,
                                  activation=lambda_hswish())
        self.se = _se(out_channels) if use_se else None

    def forward(self, x):
        x = self.conv(x)
        return self.se(x) if self.se is not None else x


class MobileNetV3Classifier(nn.Module):
    """1x1 conv -> hswish -> dropout -> 1x1 conv with bias, on the pooled
    (B, C, 1, 1) feature (JAX ``models/mobilenetv3.py:78``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int, dropout_rate: float = 0.2):
        super().__init__()
        self.conv1 = conv1x1(in_channels, mid_channels)
        self.activ = HSwish()
        self.dropout = nn.Dropout(dropout_rate)
        self.conv2 = conv1x1(mid_channels, out_channels, bias=True)

    def forward(self, x):
        return self.conv2(self.dropout(self.activ(self.conv1(x))))


def mobilenetv3(channels: Sequence[Sequence[int]],
                exp_channels: Sequence[Sequence[int]],
                init_block_channels: int, final_block_channels: int,
                classifier_mid_channels: int, kernels3, use_relu, use_se,
                first_stride: bool, final_use_se: bool,
                in_channels: int = 3, in_size: Tuple[int, int] = (224, 224),
                num_classes: int = 1000) -> ImageClassifier:
    """MobileNetV3 (JAX ``models/mobilenetv3.py:98``)."""
    layers = [("init_block", conv3x3_block(in_channels, init_block_channels,
                                           stride=2,
                                           activation=lambda_hswish()))]
    c_in = init_block_channels
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            units.append((f"unit{j + 1}", MobileNetV3Unit(
                c_in, c_out, exp_channels[i][j],
                stride=2 if j == 0 and (i != 0 or first_stride) else 1,
                use_kernel3=kernels3[i][j] == 1,
                activation=(lambda_relu() if use_relu[i][j] == 1
                            else lambda_hswish()),
                use_se=use_se[i][j] == 1)))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    layers.append(("final_block", MobileNetV3FinalBlock(
        c_in, final_block_channels, final_use_se)))
    layers.append(("final_pool", global_avg_pool2d(keepdims=True)))
    return ImageClassifier(
        Sequential(layers),
        MobileNetV3Classifier(final_block_channels, num_classes,
                              classifier_mid_channels),
        in_size=in_size, in_channels=in_channels, num_classes=num_classes,
        output_before_flatten=True)


def get_mobilenetv3(version: str, width_scale: float,
                    **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/mobilenetv3.py:131``)."""
    if version == "small":
        init_block_channels = 16
        channels = [[16], [24, 24], [40, 40, 40, 48, 48], [96, 96, 96]]
        exp_channels = [[16], [72, 88], [96, 240, 240, 120, 144],
                        [288, 576, 576]]
        kernels3 = [[1], [1, 1], [0, 0, 0, 0, 0], [0, 0, 0]]
        use_relu = [[1], [1, 1], [0, 0, 0, 0, 0], [0, 0, 0]]
        use_se = [[1], [0, 0], [1, 1, 1, 1, 1], [1, 1, 1]]
        first_stride = True
        final_block_channels = 576
    elif version == "large":
        init_block_channels = 16
        channels = [[16], [24, 24], [40, 40, 40],
                    [80, 80, 80, 80, 112, 112], [160, 160, 160]]
        exp_channels = [[16], [64, 72], [72, 120, 120],
                        [240, 200, 184, 184, 480, 672], [672, 960, 960]]
        kernels3 = [[1], [1, 1], [0, 0, 0], [1, 1, 1, 1, 1, 1], [0, 0, 0]]
        use_relu = [[1], [1, 1], [1, 1, 1], [0, 0, 0, 0, 0, 0], [0, 0, 0]]
        use_se = [[0], [0, 0], [1, 1, 1], [0, 0, 0, 0, 1, 1], [1, 1, 1]]
        first_stride = False
        final_block_channels = 960
    else:
        raise ValueError(f"Unsupported MobileNetV3 version {version}")
    if width_scale != 1.0:
        channels = [[round_channels(c * width_scale) for c in ci]
                    for ci in channels]
        exp_channels = [[round_channels(c * width_scale) for c in ci]
                        for ci in exp_channels]
        init_block_channels = round_channels(init_block_channels *
                                             width_scale)
        if width_scale > 1.0:
            final_block_channels = round_channels(final_block_channels *
                                                  width_scale)
    return mobilenetv3(channels, exp_channels, init_block_channels,
                       final_block_channels, 1280, kernels3, use_relu,
                       use_se, first_stride, final_use_se=False, **kwargs)


def _register(name: str, version: str, width_scale: float):
    def ctor(**kwargs):
        return get_mobilenetv3(version, width_scale, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _version in ("small", "large"):
    for _suffix, _scale in (("w7d20", 0.35), ("wd2", 0.5), ("w3d4", 0.75),
                            ("w1", 1.0), ("w5d4", 1.25)):
        _register(f"mobilenetv3_{_version}_{_suffix}", _version, _scale)
