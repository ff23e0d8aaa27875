"""Inception-v3's blocks (counterpart of ``pytorchcv_tpu.models.inceptionv3``;
reference pytorchcv ``models/inceptionv3.py``). Only ``ConvSeqBranch`` is
ported, the conv stack RAFT's motion encoder takes; the rest of the family
waits (ROADMAP)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..nn import ConvBlock, Sequential
from ..nn.conv import Normalization

__all__ = ["ConvSeqBranch"]


class ConvSeqBranch(nn.Module):
    """A sequence of ConvBlocks (ReLU after each) named
    ``conv_list.conv1``, ``conv2``, ... (JAX ``models/inceptionv3.py:64``):
    one block per entry of the four lists."""

    def __init__(self, in_channels: int, out_channels_list: Sequence[int],
                 kernel_size_list: Sequence, strides_list: Sequence,
                 padding_list: Sequence, bias: bool = False,
                 normalization: Normalization = None):
        super().__init__()
        convs = []
        for i, (oc, ks, st, pd) in enumerate(zip(
                out_channels_list, kernel_size_list, strides_list,
                padding_list)):
            convs.append((f"conv{i + 1}", ConvBlock(
                in_channels, oc, ks, stride=st, padding=pd, bias=bias,
                normalization=normalization)))
            in_channels = oc
        self.conv_list = Sequential(convs)

    def forward(self, x):
        return self.conv_list(x)
