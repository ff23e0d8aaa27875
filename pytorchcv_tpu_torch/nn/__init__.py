"""Building blocks of the port's models (NCHW, reference pytorchcv names)."""

from .conv import (ConvBlock, conv1x1, conv1x1_block, conv3x3_block,
                   conv7x7_block)
from .arch import MultiOutputSequential, Sequential, positional_layers
from .ops import interpolate

__all__ = ["ConvBlock", "conv1x1", "conv1x1_block", "conv3x3_block",
           "conv7x7_block", "Sequential", "MultiOutputSequential",
           "positional_layers", "interpolate"]
