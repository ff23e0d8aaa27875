"""Model families of the port; importing this registers their names."""

from . import (danet, efficientnet, propainter_rfc, resnet,  # noqa: F401
               resnetd)
from .registry import get_constructor, register_model, registered_models
from .shell import ImageClassifier

__all__ = ["get_constructor", "register_model", "registered_models",
           "ImageClassifier"]
