"""EfficientNet (B0-B8 and the TF-ported b/c variants), NCHW, with the
reference pytorchcv module names (``features.stage2.unit1.conv2.conv.weight``,
...). Counterpart of ``pytorchcv_tpu.models.efficientnet``: the same 26
registered names and the same ``get_efficientnet`` configuration table.

Every depthwise block (``EffiDwsConvUnit.dw_conv``, ``EffiInvResUnit.conv2``)
runs in eval mode as one K6 launch (``kernels.dwconv``). In ``tf_mode`` the
TF-SAME padding follows the input's size: the depthwise blocks hand their
asymmetric pad to K6, and the stem pads (``F.pad``) before its conv.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from torch import nn

from ..nn import (SEBlock, Sequential, conv1x1_block, conv3x3_block,
                  dwconv3x3_block, dwconv5x5_block, global_avg_pool2d,
                  lambda_batchnorm2d, lambda_swish, round_channels)
from .registry import register_model
from .shell import ImageClassifier

__all__ = ["calc_tf_padding", "EffiDwsConvUnit", "EffiInvResUnit",
           "EffiInitBlock", "get_efficientnet"]


def calc_tf_padding(x, kernel_size: int, stride: int = 1,
                    dilation: int = 1):
    """TF-SAME padding of an NCHW input, ((top, bottom), (left, right))
    (JAX ``models/efficientnet.py:30``)."""
    height, width = x.shape[2:]
    oh, ow = math.ceil(height / stride), math.ceil(width / stride)
    pad_h = max((oh - 1) * stride + (kernel_size - 1) * dilation + 1 -
                height, 0)
    pad_w = max((ow - 1) * stride + (kernel_size - 1) * dilation + 1 -
                width, 0)
    return ((pad_h // 2, pad_h - pad_h // 2),
            (pad_w // 2, pad_w - pad_w // 2))


class EffiDwsConvUnit(nn.Module):
    """dw 3x3 + SE + pw 1x1 (JAX ``models/efficientnet.py:45``). The
    depthwise conv does not stride; ``stride`` only decides the
    residual."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 bn_eps: float, tf_mode: bool):
        super().__init__()
        self.tf_mode = tf_mode
        self.residual = in_channels == out_channels and stride == 1
        norm, act = lambda_batchnorm2d(bn_eps), lambda_swish()
        self.dw_conv = dwconv3x3_block(in_channels, in_channels,
                                       padding=0 if tf_mode else 1,
                                       normalization=norm, activation=act)
        self.se = SEBlock(in_channels, reduction=4, mid_activation=act)
        self.pw_conv = conv1x1_block(in_channels, out_channels,
                                     normalization=norm, activation=None)

    def forward(self, x):
        identity = x
        x = self.dw_conv(x, calc_tf_padding(x, 3) if self.tf_mode else None)
        x = self.pw_conv(self.se(x))
        return x + identity if self.residual else x


class EffiInvResUnit(nn.Module):
    """MBConv: 1x1 expansion -> depthwise k x k -> SE -> 1x1 projection
    (JAX ``models/efficientnet.py:76``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, exp_factor: int, se_factor: int, bn_eps: float,
                 tf_mode: bool):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.tf_mode = tf_mode
        self.residual = in_channels == out_channels and stride == 1
        mid = in_channels * exp_factor
        norm, act = lambda_batchnorm2d(bn_eps), lambda_swish()
        self.conv1 = conv1x1_block(in_channels, mid, normalization=norm,
                                   activation=act)
        dw = dwconv3x3_block if kernel_size == 3 else dwconv5x5_block
        self.conv2 = dw(mid, mid, stride=stride,
                        padding=0 if tf_mode else kernel_size // 2,
                        normalization=norm, activation=act)
        self.se = SEBlock(mid, reduction=exp_factor * se_factor,
                          mid_activation=act) if se_factor > 0 else None
        self.conv3 = conv1x1_block(mid, out_channels, normalization=norm,
                                   activation=None)

    def forward(self, x):
        identity = x
        x = self.conv1(x)
        pad = calc_tf_padding(x, self.kernel_size, self.stride) \
            if self.tf_mode else None
        x = self.conv2(x, pad)
        if self.se is not None:
            x = self.se(x)
        x = self.conv3(x)
        return x + identity if self.residual else x


class EffiInitBlock(nn.Module):
    """3x3/2 conv block stem (JAX ``models/efficientnet.py:119``); in
    ``tf_mode`` its TF-SAME pad is an ``F.pad`` before the conv."""

    def __init__(self, in_channels: int, out_channels: int, bn_eps: float,
                 tf_mode: bool):
        super().__init__()
        self.tf_mode = tf_mode
        self.conv = conv3x3_block(in_channels, out_channels, stride=2,
                                  padding=0 if tf_mode else 1,
                                  normalization=lambda_batchnorm2d(bn_eps),
                                  activation=lambda_swish())

    def forward(self, x):
        pad = calc_tf_padding(x, 3, 2) if self.tf_mode else None
        return self.conv(x, pad)


def efficientnet(channels: Sequence[Sequence[int]], init_block_channels: int,
                 final_block_channels: int,
                 kernel_sizes: Sequence[Sequence[int]],
                 strides_per_stage: Sequence[int],
                 expansion_factors: Sequence[Sequence[int]],
                 dropout_rate: float = 0.2, tf_mode: bool = False,
                 bn_eps: float = 1e-5, in_channels: int = 3,
                 in_size: Tuple[int, int] = (224, 224),
                 num_classes: int = 1000) -> ImageClassifier:
    """EfficientNet (JAX ``models/efficientnet.py:154``)."""
    layers = [("init_block", EffiInitBlock(in_channels, init_block_channels,
                                           bn_eps, tf_mode))]
    c_in = init_block_channels
    for i, stage_channels in enumerate(channels):
        units = []
        for j, c_out in enumerate(stage_channels):
            stride = strides_per_stage[i] if j == 0 else 1
            if i == 0:
                unit = EffiDwsConvUnit(c_in, c_out, stride, bn_eps, tf_mode)
            else:
                unit = EffiInvResUnit(c_in, c_out, kernel_sizes[i][j],
                                      stride, expansion_factors[i][j], 4,
                                      bn_eps, tf_mode)
            units.append((f"unit{j + 1}", unit))
            c_in = c_out
        layers.append((f"stage{i + 1}", Sequential(units)))
    layers.append(("final_block", conv1x1_block(
        c_in, final_block_channels,
        normalization=lambda_batchnorm2d(bn_eps), activation=lambda_swish())))
    layers.append(("final_pool", global_avg_pool2d()))
    output = Sequential([("dropout", nn.Dropout(dropout_rate)),
                         ("fc", nn.Linear(final_block_channels,
                                          num_classes))])
    return ImageClassifier(Sequential(layers), output, in_size=in_size,
                           in_channels=in_channels, num_classes=num_classes)


# version: (default input size, depth factor, width factor, dropout)
_VERSIONS = {
    "b0": ((224, 224), 1.0, 1.0, 0.2), "b1": ((240, 240), 1.1, 1.0, 0.2),
    "b2": ((260, 260), 1.2, 1.1, 0.3), "b3": ((300, 300), 1.4, 1.2, 0.3),
    "b4": ((380, 380), 1.8, 1.4, 0.4), "b5": ((456, 456), 2.2, 1.6, 0.4),
    "b6": ((528, 528), 2.6, 1.8, 0.5), "b7": ((600, 600), 3.1, 2.0, 0.5),
    "b8": ((672, 672), 3.6, 2.2, 0.5),
}


def _expand(vals, layers, downsample):
    """Per-layer values -> per-stage lists of per-unit values; a layer
    without downsampling joins the stage before it."""
    out: list = []
    for v, li, di in zip(vals, layers, downsample):
        if di != 0:
            out.append([v] * li)
        else:
            out[-1] = out[-1] + [v] * li
    return out


def get_efficientnet(version: str, in_size=None, tf_mode: bool = False,
                     bn_eps: float = 1e-5, **kwargs) -> ImageClassifier:
    """Configuration expander (JAX ``models/efficientnet.py:214``)."""
    if version not in _VERSIONS:
        raise ValueError(f"Unsupported EfficientNet version {version}")
    default_size, depth_factor, width_factor, dropout_rate = \
        _VERSIONS[version]
    layers = [1, 2, 2, 3, 3, 4, 1]
    downsample = [1, 1, 1, 1, 0, 1, 0]
    channels_per_layers = [16, 24, 40, 80, 112, 192, 320]
    expansion_factors_per_layers = [1, 6, 6, 6, 6, 6, 6]
    kernel_sizes_per_layers = [3, 3, 5, 3, 5, 5, 3]
    strides_per_stage = [1, 2, 2, 2, 1, 2, 1]
    final_block_channels = 1280

    layers = [int(math.ceil(li * depth_factor)) for li in layers]
    channels_per_layers = [round_channels(ci * width_factor)
                           for ci in channels_per_layers]
    init_block_channels = round_channels(32 * width_factor)
    if width_factor > 1.0:
        final_block_channels = round_channels(final_block_channels *
                                              width_factor)
    return efficientnet(
        channels=_expand(channels_per_layers, layers, downsample),
        init_block_channels=init_block_channels,
        final_block_channels=final_block_channels,
        kernel_sizes=_expand(kernel_sizes_per_layers, layers, downsample),
        strides_per_stage=[s[0] for s in _expand(strides_per_stage, layers,
                                                 downsample)],
        expansion_factors=_expand(expansion_factors_per_layers, layers,
                                  downsample),
        dropout_rate=dropout_rate, tf_mode=tf_mode, bn_eps=bn_eps,
        in_size=default_size if in_size is None else in_size, **kwargs)


def _register(name: str, version: str, tf_mode: bool = False,
              bn_eps: float = 1e-5):
    def ctor(**kwargs):
        return get_efficientnet(version, tf_mode=tf_mode, bn_eps=bn_eps,
                                **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _v in ["b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8"]:
    _register(f"efficientnet_{_v}", _v)
for _v in ["b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7"]:
    _register(f"efficientnet_{_v}b", _v, tf_mode=True, bn_eps=1e-3)
for _v in ["b0", "b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8"]:
    _register(f"efficientnet_{_v}c", _v, tf_mode=True, bn_eps=1e-3)
