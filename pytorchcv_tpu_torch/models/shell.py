"""Generic model shells."""

from __future__ import annotations

from typing import Tuple

from torch import nn

__all__ = ["ImageClassifier"]


class ImageClassifier(nn.Module):
    """features -> flatten -> output head (NCHW input)."""

    def __init__(self, features: nn.Module, output: nn.Module,
                 in_size: Tuple[int, int] = (224, 224), in_channels: int = 3,
                 num_classes: int = 1000):
        super().__init__()
        self.features = features
        self.output = output
        self.in_size = tuple(in_size)
        self.in_channels = in_channels
        self.num_classes = num_classes

    def forward(self, x):
        x = self.features(x)
        return self.output(x.flatten(1))
