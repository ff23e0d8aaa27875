"""Model families of the port; importing this registers their names."""

from . import danet, resnet, resnetd  # noqa: F401  (register the names)
from .registry import get_constructor, register_model, registered_models
from .shell import ImageClassifier

__all__ = ["get_constructor", "register_model", "registered_models",
           "ImageClassifier"]
