"""Model families of the port; importing this registers their names."""

from . import (danet, efficientnet, propainter, propainter_ip,  # noqa: F401
               propainter_rfc, resnet, resnetd, wrn)
from .registry import get_constructor, register_model, registered_models
from .shell import ImageClassifier

__all__ = ["get_constructor", "register_model", "registered_models",
           "ImageClassifier"]
