"""int8 post-training quantization: calibration, the ResNet pipeline, the
segmentation-backbone and plain-trunk pipelines, the MobileNet v1 / v2
pipelines, and the VGG, DarkNet-53 and PreResNet / SE-PreResNet
pipelines."""

from .darknet_int8 import is_darknet53_tree, prepare_int8_darknet
from .mobilenet_int8 import (is_mobilenet_v1_tree, is_mobilenet_v2_tree,
                             prepare_int8_mobilenet,
                             prepare_int8_mobilenet_v1)
from .preresnet_int8 import is_plain_preresnet_tree, prepare_int8_preresnet
from .ptq import calibrate_int8
from .resnet_int8 import (UnsupportedTreeError, is_plain_resnet_tree,
                          prepare_int8_resnet)
from .seg_backbone_int8 import (is_plain_resnet_trunk,
                                is_seg_resnetd_backbone,
                                prepare_int8_plain_trunk,
                                prepare_int8_seg_backbone)
from .vgg_int8 import is_plain_vgg, prepare_int8_vgg

__all__ = ["calibrate_int8", "prepare_int8_resnet", "UnsupportedTreeError",
           "is_plain_resnet_tree",
           "is_seg_resnetd_backbone", "prepare_int8_seg_backbone",
           "is_plain_resnet_trunk", "prepare_int8_plain_trunk",
           "is_mobilenet_v1_tree", "is_mobilenet_v2_tree",
           "prepare_int8_mobilenet", "prepare_int8_mobilenet_v1",
           "is_plain_vgg", "prepare_int8_vgg", "is_darknet53_tree",
           "prepare_int8_darknet", "is_plain_preresnet_tree",
           "prepare_int8_preresnet"]
