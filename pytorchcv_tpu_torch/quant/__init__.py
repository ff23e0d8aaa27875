"""int8 post-training quantization: calibration, the ResNet pipeline and
the segmentation-backbone pipeline."""

from .ptq import calibrate_int8
from .resnet_int8 import UnsupportedTreeError, prepare_int8_resnet
from .seg_backbone_int8 import (is_seg_resnetd_backbone,
                                prepare_int8_seg_backbone)

__all__ = ["calibrate_int8", "prepare_int8_resnet", "UnsupportedTreeError",
           "is_seg_resnetd_backbone", "prepare_int8_seg_backbone"]
