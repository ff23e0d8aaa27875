"""SENet's deep stem (counterpart of ``pytorchcv_tpu.models.senet``'s
``SEInitBlock``); the SENet models themselves are not yet ported."""

from __future__ import annotations

from torch import nn

from ..nn import conv3x3_block

__all__ = ["SEInitBlock"]


class SEInitBlock(nn.Module):
    """3x3/2 conv block to ``out_channels // 2``, 3x3 conv block, 3x3 conv
    block to ``out_channels``, then a 3x3/2 max-pool (reference
    senet.py:126)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        mid = out_channels // 2
        self.conv1 = conv3x3_block(in_channels, mid, stride=2)
        self.conv2 = conv3x3_block(mid, mid)
        self.conv3 = conv3x3_block(mid, out_channels)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x):
        return self.pool(self.conv3(self.conv2(self.conv1(x))))
