"""Convolution blocks: conv + BatchNorm + activation, with the reference
pytorchcv child names (``conv``, ``bn``, ``activ``) so ``state_dict`` keys
match the released checkpoints and the JAX package's parameter tree."""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._build import autograd_records
from ..kernels.dwconv import dwconv2d_bn_act
from .activ import Activation, HSwish, Swish, create_activation
from .norm import BN_EPS, fold_batchnorm

__all__ = ["ConvBlock", "DwsConvBlock", "DeconvBlock", "conv1x1",
           "conv1x1_block", "conv3x3_block", "conv7x7_block",
           "dwconv_block", "dwconv3x3_block", "dwconv5x5_block",
           "dwsconv3x3_block", "unfused_depthwise"]

Normalization = Union[bool, Callable[[int], nn.Module]]
Pad = Tuple[Tuple[int, int], Tuple[int, int]]

# K6's name for each activation module whose arithmetic it repeats
# (HSwish divides by 6: K6's "hswish_div", not the TPU kernel's "hswish").
_K6_ACTS = {Swish: "swish", nn.ReLU: "relu", nn.ReLU6: "relu6",
            HSwish: "hswish_div"}


class ConvBlock(nn.Module):
    """conv + optional BatchNorm2d + optional activation (NCHW). The
    padding is the caller's, as in the reference (a dilated 3x3 passes
    ``padding=dilation``). ``activation``: ``True`` ReLU, ``False``/``None``
    none, or a factory (``nn.activ.lambda_leakyrelu(0.1)``).
    ``normalization``: ``True`` BatchNorm2d(eps=1e-5), a factory of
    channels (``nn.norm.lambda_batchnorm2d(1e-3)``), or ``False``: no
    ``bn`` child (ProPainter's blocks).

    A depthwise block (``groups == in == out`` channels, k in (3, 5, 7),
    stride 1 or 2, no dilation, no bias) with BN and swish, ReLU, ReLU6 or
    hswish (``_K6_ACTS``) runs in eval
    mode as one K6 launch (``kernels.dwconv``), BN folded on every call.
    It runs conv, BN and activation unfused in training mode, whenever
    autograd records the forward (K6 has no backward yet), and inside
    :func:`unfused_depthwise`. Under ``torch.autocast`` on x's device with
    dtype bf16 it casts x and the conv weight to bf16, as autocast's own
    conv would, and launches K6 (scale and shift stay f32); under any other
    autocast dtype (f16, which K6 does not take) it runs unfused."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = False,
                 normalization: Normalization = True,
                 activation: Activation = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              dilation=dilation, groups=groups, bias=bias)
        if normalization is True:
            self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS)
        else:
            self.bn = normalization(out_channels) if normalization else None
        self.activ = create_activation(activation)
        self.fused_dw = (groups == in_channels == out_channels
                         and kernel_size in (3, 5, 7)
                         and stride in (1, 2) and dilation == 1 and not bias
                         and isinstance(self.bn, nn.BatchNorm2d)
                         and type(self.activ) in _K6_ACTS)

    def forward(self, x, pad: Optional[Pad] = None):
        """``pad``: ((top, bottom), (left, right)) zeros for this call, for
        a block built with padding 0 (TF-SAME, whose pad follows the
        input's size)."""
        if self.fused_dw and not self.training and not autograd_records(
                x, self.conv.weight, self.bn.weight, self.bn.bias):
            dev = x.device.type
            cast = torch.get_autocast_dtype(dev) \
                if torch.is_autocast_enabled(dev) else None
            if cast in (None, torch.bfloat16):
                return self._dwconv(x, pad, cast)
        if pad is not None:
            (top, bottom), (left, right) = pad
            x = F.pad(x, (left, right, top, bottom))
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activ is not None:
            x = self.activ(x)
        return x

    def _dwconv(self, x, pad: Optional[Pad], cast: Optional[torch.dtype]):
        if pad is None:
            ph, pw = self.conv.padding
            pad = ((ph, ph), (pw, pw))
        w = self.conv.weight
        if cast is not None:
            x, w = x.to(cast), w.to(cast)
        scale, shift = fold_batchnorm(self.bn)
        return dwconv2d_bn_act(x.contiguous(), w, scale, shift,
                               self.conv.stride[0], pad,
                               _K6_ACTS[type(self.activ)])


@contextlib.contextmanager
def unfused_depthwise(model: nn.Module) -> Iterator[nn.Module]:
    """Inside the block, ``model``'s depthwise blocks run conv, BN and
    activation unfused in eval mode too: a forward with no K6 in it (the
    f32 oracle of the serving routes)."""
    blocks = [m for m in model.modules()
              if isinstance(m, ConvBlock) and m.fused_dw]
    for m in blocks:
        m.fused_dw = False
    try:
        yield model
    finally:
        for m in blocks:
            m.fused_dw = True


def conv1x1(in_channels: int, out_channels: int,
            bias: bool = False) -> nn.Conv2d:
    """Plain 1x1 convolution (no BN): the DANet head's projections and
    classifiers."""
    return nn.Conv2d(in_channels, out_channels, 1, bias=bias)


def conv1x1_block(in_channels: int, out_channels: int, stride: int = 1,
                  **kwargs) -> ConvBlock:
    return ConvBlock(in_channels, out_channels, 1, stride=stride, padding=0,
                     **kwargs)


def conv3x3_block(in_channels: int, out_channels: int, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  **kwargs) -> ConvBlock:
    return ConvBlock(in_channels, out_channels, 3, stride=stride,
                     padding=padding, dilation=dilation, **kwargs)


def conv7x7_block(in_channels: int, out_channels: int, stride: int = 1,
                  **kwargs) -> ConvBlock:
    return ConvBlock(in_channels, out_channels, 7, stride=stride, padding=3,
                     **kwargs)


def dwconv_block(in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 1, **kwargs) -> ConvBlock:
    """Depthwise ConvBlock (JAX ``nn/conv.py:167``)."""
    return ConvBlock(in_channels, out_channels, kernel_size, stride=stride,
                     padding=padding, groups=out_channels, **kwargs)


def dwconv3x3_block(in_channels: int, out_channels: int, stride: int = 1,
                    padding: int = 1, **kwargs) -> ConvBlock:
    return dwconv_block(in_channels, out_channels, 3, stride=stride,
                        padding=padding, **kwargs)


def dwconv5x5_block(in_channels: int, out_channels: int, stride: int = 1,
                    padding: int = 2, **kwargs) -> ConvBlock:
    return dwconv_block(in_channels, out_channels, 5, stride=stride,
                        padding=padding, **kwargs)


class DwsConvBlock(nn.Module):
    """Depthwise-separable block (JAX ``nn/conv.py:182``): a
    depthwise k x k :class:`ConvBlock` ``dw_conv`` (BN with ``dw_use_bn``,
    ``dw_activation``) and a 1x1 :class:`ConvBlock` ``pw_conv`` (BN with
    ``pw_use_bn``, ``pw_activation``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dw_use_bn: bool = True, pw_use_bn: bool = True,
                 dw_activation: Activation = True,
                 pw_activation: Activation = True):
        super().__init__()
        self.dw_conv = dwconv_block(in_channels, in_channels, kernel_size,
                                    stride=stride, padding=padding,
                                    normalization=dw_use_bn,
                                    activation=dw_activation)
        self.pw_conv = conv1x1_block(in_channels, out_channels,
                                     normalization=pw_use_bn,
                                     activation=pw_activation)

    def forward(self, x):
        return self.pw_conv(self.dw_conv(x))


def dwsconv3x3_block(in_channels: int, out_channels: int, stride: int = 1,
                     padding: int = 1, **kwargs) -> DwsConvBlock:
    """3x3 depthwise-separable block (JAX ``nn/conv.py:227``)."""
    return DwsConvBlock(in_channels, out_channels, 3, stride=stride,
                        padding=padding, **kwargs)


class DeconvBlock(nn.Module):
    """4x4/2 transposed conv (padding 1, no bias) + BatchNorm2d + ReLU, the
    x2 upsampling block of SimplePose and CenterNet (JAX ``nn/conv.py:384``
    at its defaults; its ``ConvTranspose2d`` at ``:325`` is
    ``nn.ConvTranspose2d``): children ``conv``, ``bn``, ``activ``. The JAX
    kernel (kH, kW, O, I) converts to ``nn.ConvTranspose2d``'s
    (I, O, kH, kW) by the converter's 4-D rule, the rule of every conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_channels, out_channels, 4,
                                       stride=2, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS)
        self.activ = nn.ReLU()

    def forward(self, x):
        return self.activ(self.bn(self.conv(x)))
