"""Model families of the port; importing this registers their names."""

from . import (danet, efficientnet, mobilenet, mobilenetv2,  # noqa: F401
               mobilenetv3, propainter, propainter_ip, propainter_rfc, raft,
               resnet, resnetd, resnext, senet, seresnet, seresnext, wrn)
from .registry import get_constructor, register_model, registered_models
from .shell import ImageClassifier

__all__ = ["get_constructor", "register_model", "registered_models",
           "ImageClassifier"]
