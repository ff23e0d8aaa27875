"""Model families of the port; importing this registers their names."""

from . import danet, propainter_rfc, resnet, resnetd  # noqa: F401
from .registry import get_constructor, register_model, registered_models
from .shell import ImageClassifier

__all__ = ["get_constructor", "register_model", "registered_models",
           "ImageClassifier"]
