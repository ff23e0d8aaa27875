"""Containers."""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

from torch import nn

__all__ = ["Sequential"]


def Sequential(layers: Sequence[Tuple[str, nn.Module]]) -> nn.Sequential:
    """``nn.Sequential`` whose children carry the given names, so their
    ``state_dict`` keys read ``features.stage1.unit1...``."""
    return nn.Sequential(OrderedDict(layers))
