"""Generic model shells."""

from __future__ import annotations

from typing import Tuple

from torch import nn

__all__ = ["ImageClassifier"]


class ImageClassifier(nn.Module):
    """features -> flatten -> output head (NCHW input). With
    ``output_before_flatten`` the head runs on the pooled (B, C, 1, 1)
    feature and its output is flattened (a 1x1-conv classifier, JAX
    ``models/shell.py``: MobileNetV2, MobileNetV3)."""

    def __init__(self, features: nn.Module, output: nn.Module,
                 in_size: Tuple[int, int] = (224, 224), in_channels: int = 3,
                 num_classes: int = 1000,
                 output_before_flatten: bool = False):
        super().__init__()
        self.features = features
        self.output = output
        self.in_size = tuple(in_size)
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.output_before_flatten = output_before_flatten

    def forward(self, x):
        x = self.features(x)
        if self.output_before_flatten:
            return self.output(x).flatten(1)
        return self.output(x.flatten(1))
