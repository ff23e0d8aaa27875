"""Model families of the port; importing this registers their names."""

from . import (alphapose_coco, centernet, danet, deeplabv3,  # noqa: F401
               efficientnet, fastseresnet, fcn8sd, mobilenet, mobilenetv2,
               mobilenetv3, propainter, propainter_ip, propainter_rfc,
               pspnet, raft, resnet, resnetd, resnext, senet, seresnet,
               seresnext, simplepose_coco, wrn)
from .registry import get_constructor, register_model, registered_models
from .shell import ImageClassifier

__all__ = ["get_constructor", "register_model", "registered_models",
           "ImageClassifier"]
