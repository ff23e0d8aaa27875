"""Building blocks of the port's models (NCHW, reference pytorchcv names)."""

from .activ import create_activation, lambda_leakyrelu
from .conv import (ConvBlock, conv1x1, conv1x1_block, conv3x3_block,
                   conv7x7_block)
from .arch import (Hourglass, IndexedSeq, MultiOutputSequential, Sequential,
                   positional_layers)
from .ops import BreakBlock, InterpolationBlock, interpolate

__all__ = ["ConvBlock", "conv1x1", "conv1x1_block", "conv3x3_block",
           "conv7x7_block", "Sequential", "MultiOutputSequential",
           "positional_layers", "IndexedSeq", "Hourglass", "interpolate",
           "BreakBlock", "InterpolationBlock", "create_activation",
           "lambda_leakyrelu"]
