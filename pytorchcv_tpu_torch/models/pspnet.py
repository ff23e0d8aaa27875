"""The segmentation backbone shared by the dense-prediction heads
(counterpart of ``pytorchcv_tpu.models.pspnet.segmentation_backbone``);
PSPNet itself is not yet ported."""

from __future__ import annotations

from typing import Sequence

from ..nn import MultiOutputSequential, positional_layers
from .resnetd import _LAYERS, resnetd_features

__all__ = ["segmentation_backbone"]


def segmentation_backbone(blocks: int, bends: Sequence[int] = (3,),
                          in_channels: int = 3) -> MultiOutputSequential:
    """ResNet(D)-b trunk with stage taps and no final pool, its children
    renamed "0".."4" as the reference composes it (pspnet.py:276-280:
    ``resnetd50b(...).features`` minus the pool). Returns
    ``[stage4, *bend_stages]``."""
    bottleneck = blocks >= 50
    per_layer = [256, 512, 1024, 2048] if bottleneck else [64, 128, 256, 512]
    channels = [[c] * n for c, n in zip(per_layer, _LAYERS[blocks])]
    feats = resnetd_features(channels, 64, bottleneck, conv1_stride=False,
                             bends=bends, final_pool=False,
                             in_channels=in_channels)
    return MultiOutputSequential(positional_layers(feats.named_children()),
                                 feats.output_idx)
