"""SimplePose for COCO keypoints (NCHW), with the reference pytorchcv module
names. Counterpart of ``pytorchcv_tpu.models.simplepose_coco``'s ResNet
variants (4 names): the plain ResNet trunk without its pool, three x2
deconv blocks, a 1x1 heatmap conv and the keypoint decode
(``HeatmapMaxDetBlock``). The ``resneta`` variants are not yet ported."""

from __future__ import annotations

from typing import Sequence, Tuple

from torch import nn

from ..nn import (DeconvBlock, HeatmapMaxDetBlock, Sequential, conv1x1,
                  positional_layers)
from .registry import register_model
from .resnet import _LAYERS, resnet_features

__all__ = ["SimplePose", "plain_trunk"]


def plain_trunk(blocks: int, conv1_stride: bool) -> nn.Sequential:
    """The ResNet trunk without its final pool, children renamed "0".."4"
    as the reference slices it (the SimplePose and CenterNet backbones)."""
    bottleneck = blocks >= 50
    per_layer = [256, 512, 1024, 2048] if bottleneck else [64, 128, 256, 512]
    channels = [[c] * n for c, n in
                zip(per_layer, _LAYERS[(blocks, bottleneck)])]
    feats = resnet_features(channels, 64, bottleneck, conv1_stride,
                            final_pool=False)
    return Sequential(positional_layers(feats.named_children()))


class SimplePose(nn.Module):
    """SimplePose (JAX ``models/simplepose_coco.py:22``): backbone ->
    ``decoder`` (``unit1..3``: x2 deconv blocks, ``final_block``: 1x1
    conv with bias) -> heatmaps (B, keypoints, H/4, W/4) with
    ``return_heatmap``, else their keypoints (B, keypoints, 3).
    ``forward(x, from_features=True)`` takes the backbone's output, the
    head-only entry of the int8 serving pipeline."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 2048,
                 channels: Sequence[int] = (256, 256, 256),
                 return_heatmap: bool = False,
                 in_size: Tuple[int, int] = (256, 192), in_channels: int = 3,
                 keypoints: int = 17):
        super().__init__()
        self.backbone = backbone
        units, c_in = [], backbone_out_channels
        for i, c in enumerate(channels):
            units.append((f"unit{i + 1}", DeconvBlock(c_in, c)))
            c_in = c
        units.append(("final_block", conv1x1(c_in, keypoints, bias=True)))
        self.decoder = Sequential(units)
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


def _variant(name: str, blocks: int, out_channels: int):
    def ctor(keypoints: int = 17, **kwargs):
        return SimplePose(plain_trunk(blocks, conv1_stride=(blocks == 18)),
                          out_channels, keypoints=keypoints, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _blocks, _out in (("simplepose_resnet18_coco", 18, 512),
                             ("simplepose_resnet50b_coco", 50, 2048),
                             ("simplepose_resnet101b_coco", 101, 2048),
                             ("simplepose_resnet152b_coco", 152, 2048)):
    _variant(_name, _blocks, _out)
