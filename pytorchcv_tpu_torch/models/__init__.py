"""Model families of the port; importing this registers their names."""

from . import (alphapose_coco, centernet, danet, darknet53,  # noqa: F401
               deeplabv3, efficientnet, fastseresnet, fcn8sd, mobilenet,
               mobilenetv2, mobilenetv3, preresnet, propainter,
               propainter_ip, propainter_rfc, pspnet, raft, resnet, resnetd,
               resnext, senet, sepreresnet, seresnet, seresnext,
               simplepose_coco, vgg, wrn)
from .registry import get_constructor, register_model, registered_models
from .shell import ImageClassifier

__all__ = ["get_constructor", "register_model", "registered_models",
           "ImageClassifier"]
