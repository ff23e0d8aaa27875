"""Building blocks of the port's models (NCHW, reference pytorchcv names)."""

from .activ import (HSigmoid, HSwish, create_activation, lambda_hsigmoid,
                    lambda_hswish, lambda_leakyrelu, lambda_relu,
                    lambda_relu6, lambda_sigmoid, lambda_swish, lambda_tanh)
from .conv import (ConvBlock, DeconvBlock, DwsConvBlock, conv1x1, conv1x1_block,
                   conv3x3_block, conv7x7_block, dwconv3x3_block,
                   dwconv5x5_block, dwconv_block, dwsconv3x3_block,
                   unfused_depthwise)
from .arch import (Concurrent, Hourglass, IndexedSeq, MultiOutputSequential,
                   Sequential, positional_layers)
from .att import SEBlock, round_channels
from .norm import fold_batchnorm, lambda_batchnorm2d, lambda_instancenorm2d
from .ops import (BreakBlock, DucBlock, HeatmapMaxDetBlock,
                  InterpolationBlock, global_avg_pool2d, grid_sample,
                  interpolate)

__all__ = ["ConvBlock", "DwsConvBlock", "dwsconv3x3_block", "HSigmoid",
           "HSwish", "lambda_relu", "lambda_relu6", "lambda_hsigmoid",
           "lambda_hswish", "conv1x1", "conv1x1_block", "conv3x3_block",
           "conv7x7_block", "dwconv_block", "dwconv3x3_block",
           "dwconv5x5_block", "unfused_depthwise", "Sequential", "MultiOutputSequential",
           "positional_layers", "IndexedSeq", "Hourglass", "interpolate",
           "grid_sample",
           "BreakBlock", "InterpolationBlock", "global_avg_pool2d",
           "SEBlock", "round_channels", "create_activation",
           "lambda_leakyrelu", "lambda_swish", "lambda_sigmoid", "lambda_tanh",
           "lambda_batchnorm2d", "lambda_instancenorm2d", "fold_batchnorm",
           "Concurrent", "DeconvBlock", "DucBlock", "HeatmapMaxDetBlock"]
