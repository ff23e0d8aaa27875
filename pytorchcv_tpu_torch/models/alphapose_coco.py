"""AlphaPose for COCO keypoints (NCHW), with the reference pytorchcv module
names. Counterpart of ``pytorchcv_tpu.models.alphapose_coco``: one
registered name. The Fast-SE-ResNet-101b trunk without its pool, a pixel
shuffle, two DUC blocks, a 3x3 heatmap conv and the keypoint decode."""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import DucBlock, HeatmapMaxDetBlock, Sequential, positional_layers
from .fastseresnet import fastseresnet_features
from .registry import register_model

__all__ = ["AlphaPose"]


class AlphaPose(nn.Module):
    """AlphaPose (JAX ``models/alphapose_coco.py:16``): backbone ->
    ``decoder`` (a x2 pixel shuffle, ``unit1..``: DUC blocks,
    ``final_block``: 3x3 conv with bias) -> heatmaps (B, keypoints, H/4,
    W/4) with ``return_heatmap``, else their keypoints (B, keypoints, 3).
    ``forward(x, from_features=True)`` takes the backbone's output, the
    head-only entry of the int8 serving pipeline."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 2048,
                 channels: Sequence[int] = (256, 128),
                 return_heatmap: bool = False,
                 in_size: Tuple[int, int] = (256, 192), in_channels: int = 3,
                 keypoints: int = 17):
        super().__init__()
        self.backbone = backbone
        c_in = backbone_out_channels // 4
        layers = [("init_block", nn.PixelShuffle(2))]
        for i, c in enumerate(channels):
            layers.append((f"unit{i + 1}", DucBlock(c_in, c, 2)))
            c_in = c
        layers.append(("final_block", nn.Conv2d(c_in, keypoints, 3,
                                                padding=1)))
        self.decoder = Sequential(layers)
        self.heatmap_max_det = HeatmapMaxDetBlock()
        self.return_heatmap = return_heatmap
        self.in_size = tuple(in_size)
        self.in_channels = in_channels
        self.keypoints = keypoints

    @property
    def num_classes(self) -> int:
        return self.keypoints

    def forward(self, x, from_features: bool = False):
        heatmap = self.decoder(x if from_features else self.backbone(x))
        if self.return_heatmap:
            return heatmap
        return self.heatmap_max_det(heatmap)


@register_model("alphapose_fastseresnet101b_coco")
def alphapose_fastseresnet101b_coco(keypoints: int = 17,
                                    **kwargs) -> AlphaPose:
    feats = fastseresnet_features(
        [[256] * 3, [512] * 4, [1024] * 23, [2048] * 3], 64, True,
        conv1_stride=False, final_pool=False)
    return AlphaPose(Sequential(positional_layers(feats.named_children())),
                     2048, keypoints=keypoints, **kwargs)
