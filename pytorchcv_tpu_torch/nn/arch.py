"""Containers."""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

from torch import nn

__all__ = ["Sequential", "MultiOutputSequential", "positional_layers"]


def Sequential(layers: Sequence[Tuple[str, nn.Module]]) -> nn.Sequential:
    """``nn.Sequential`` whose children carry the given names, so their
    ``state_dict`` keys read ``features.stage1.unit1...``."""
    return nn.Sequential(OrderedDict(layers))


def positional_layers(layers: Sequence[Tuple[str, nn.Module]]
                      ) -> List[Tuple[str, nn.Module]]:
    """Rename children to "0", "1", ...: torch's ``del seq[-1]`` re-keys a
    sliced backbone positionally, so the reference checkpoints of composed
    heads store ``backbone.0...`` keys (JAX ``nn/arch.py:27``)."""
    return [(str(i), m) for i, (_, m) in enumerate(layers)]


class MultiOutputSequential(nn.Sequential):
    """Sequential that also returns the outputs of the children at
    ``output_idx`` (feature taps): ``[last, *taps]`` (JAX ``nn/arch.py:148``,
    reference arch.py:309)."""

    def __init__(self, layers: Sequence[Tuple[str, nn.Module]],
                 output_idx: Sequence[int] = ()):
        super().__init__(OrderedDict(layers))
        self.output_idx = tuple(output_idx)

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in self.output_idx:
                outs.append(x)
        return [x] + outs
