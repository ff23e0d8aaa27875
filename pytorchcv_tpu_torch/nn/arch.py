"""Containers."""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

import torch
from torch import nn

__all__ = ["Sequential", "MultiOutputSequential", "positional_layers",
           "IndexedSeq", "Hourglass", "Concurrent"]


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


class Concurrent(nn.Sequential):
    """Named branches applied to the same input, their outputs concatenated
    on the channel axis (dim 1, NCHW): JAX ``nn/arch.py:90`` with its
    default ``cat`` merge (reference arch.py:58)."""

    def __init__(self, layers: Sequence[Tuple[str, nn.Module]]):
        super().__init__(OrderedDict(layers))

    def forward(self, x):
        return torch.cat([layer(x) for layer in self], dim=1)


class IndexedSeq(nn.Sequential):
    """Named children applied by index: ``seq(x, i)`` is ``seq[i](x)``
    (JAX ``nn/arch.py:246``; the ``down_seq``/``up_seq``/``skip_seq``
    scopes of :class:`Hourglass`)."""

    def __init__(self, layers: Sequence[Tuple[str, nn.Module]]):
        super().__init__(OrderedDict(layers))

    def forward(self, x, i: int):
        return self[i](x)


class Hourglass(nn.Module):
    """Down path, up path and skip connections merged by addition (JAX
    ``nn/arch.py:257`` with ``merge_type="add"``, reference arch.py:168).
    A skip that returns None (``BreakBlock``) is cut. With one skip more
    than the depth, the extra one runs on the deepest output before the
    first up block."""

    def __init__(self, down_seq: Sequence[Tuple[str, nn.Module]],
                 up_seq: Sequence[Tuple[str, nn.Module]],
                 skip_seq: Sequence[Tuple[str, nn.Module]]):
        super().__init__()
        self.down_seq = IndexedSeq(down_seq)
        self.up_seq = IndexedSeq(up_seq)
        self.skip_seq = IndexedSeq(skip_seq)

    def forward(self, x):
        depth = len(self.down_seq)
        down_outs = [x]
        for i in range(depth):
            x = self.down_seq(x, i)
            down_outs.append(x)
        for i in range(depth + 1):
            if i != 0:
                y = self.skip_seq(down_outs[depth - i], depth - i)
                if y is not None:
                    x = x + y
            if i != depth:
                if i == 0 and len(self.skip_seq) > depth:
                    x = self.skip_seq(x, depth)
                x = self.up_seq(x, depth - 1 - i)
        return x
