"""int8 post-training quantization: calibration and the ResNet pipeline."""

from .ptq import calibrate_int8
from .resnet_int8 import UnsupportedTreeError, prepare_int8_resnet

__all__ = ["calibrate_int8", "prepare_int8_resnet", "UnsupportedTreeError"]
