"""Building blocks of the port's models (NCHW, reference pytorchcv names)."""

from .activ import (create_activation, lambda_leakyrelu, lambda_sigmoid,
                    lambda_swish, lambda_tanh)
from .conv import (ConvBlock, conv1x1, conv1x1_block, conv3x3_block,
                   conv7x7_block, dwconv3x3_block, dwconv5x5_block,
                   dwconv_block, unfused_depthwise)
from .arch import (Hourglass, IndexedSeq, MultiOutputSequential, Sequential,
                   positional_layers)
from .att import SEBlock, round_channels
from .norm import fold_batchnorm, lambda_batchnorm2d
from .ops import (BreakBlock, InterpolationBlock, global_avg_pool2d,
                  grid_sample, interpolate)

__all__ = ["ConvBlock", "conv1x1", "conv1x1_block", "conv3x3_block",
           "conv7x7_block", "dwconv_block", "dwconv3x3_block",
           "dwconv5x5_block", "unfused_depthwise", "Sequential", "MultiOutputSequential",
           "positional_layers", "IndexedSeq", "Hourglass", "interpolate",
           "grid_sample",
           "BreakBlock", "InterpolationBlock", "global_avg_pool2d",
           "SEBlock", "round_channels", "create_activation",
           "lambda_leakyrelu", "lambda_swish", "lambda_sigmoid", "lambda_tanh",
           "lambda_batchnorm2d", "fold_batchnorm"]
