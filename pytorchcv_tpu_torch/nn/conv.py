"""Convolution blocks: conv + BatchNorm + activation, with the reference
pytorchcv child names (``conv``, ``bn``, ``activ``) so ``state_dict`` keys
match the released checkpoints and the JAX package's parameter tree."""

from __future__ import annotations

from torch import nn

from .activ import Activation, create_activation

__all__ = ["ConvBlock", "conv1x1", "conv1x1_block", "conv3x3_block",
           "conv7x7_block"]

BN_EPS = 1e-5


class ConvBlock(nn.Module):
    """conv + optional BatchNorm2d(eps=1e-5) + optional activation (NCHW).
    The padding is the caller's, as in the reference (a dilated 3x3 passes
    ``padding=dilation``). ``activation``: ``True`` ReLU, ``False``/``None``
    none, or a factory (``nn.activ.lambda_leakyrelu(0.1)``); without
    ``normalization`` there is no ``bn`` child (ProPainter's blocks)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, normalization: bool = True,
                 activation: Activation = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              dilation=dilation, bias=bias)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS) \
            if normalization else None
        self.activ = create_activation(activation)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activ is not None:
            x = self.activ(x)
        return x


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
