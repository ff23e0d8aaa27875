"""DeepLabv3 (NCHW), with the reference pytorchcv module names. Counterpart
of ``pytorchcv_tpu.models.deeplabv3``: the same 10 registered names (the
ResNet(D)-152b trunk among them). The head reads the backbone's stage-3
"bend" only with ``aux``."""

from __future__ import annotations

from typing import Optional, Tuple

from torch import nn

from ..nn import Concurrent, conv1x1_block, conv3x3_block, interpolate
from .pspnet import PSPFinalBlock, SegmentationHead, segmentation_backbone
from .registry import register_model

__all__ = ["DeepLabv3FinalBlock", "ASPPAvgBranch",
           "AtrousSpatialPyramidPooling", "DeepLabv3"]


# 3x3 conv block -> dropout -> 1x1 conv -> bilinear up (JAX
# models/deeplabv3.py:19): PSPNet's final block.
DeepLabv3FinalBlock = PSPFinalBlock


class ASPPAvgBranch(nn.Module):
    """Global average pool -> 1x1 conv block -> bilinear up to
    ``upscale_out_size`` (the input's size when None) (JAX
    ``models/deeplabv3.py:43``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 upscale_out_size: Optional[Tuple[int, int]]):
        super().__init__()
        self.upscale_out_size = upscale_out_size
        self.conv = conv1x1_block(in_channels, out_channels)

    def forward(self, x):
        size = self.upscale_out_size or tuple(x.shape[2:])
        return interpolate(self.conv(x.mean((2, 3), keepdim=True)), size)


class AtrousSpatialPyramidPooling(nn.Module):
    """A 1x1 branch, three atrous 3x3 branches (rates 12, 24, 36) and the
    global branch, each ``in / 8`` wide, concatenated, then a 1x1
    projection and dropout (JAX ``models/deeplabv3.py:62``)."""

    def __init__(self, in_channels: int,
                 upscale_out_size: Optional[Tuple[int, int]]):
        super().__init__()
        mid = in_channels // 8
        branches = [("branch1", conv1x1_block(in_channels, mid))]
        for i, rate in enumerate((12, 24, 36)):
            branches.append((f"branch{i + 2}", conv3x3_block(
                in_channels, mid, padding=rate, dilation=rate)))
        branches.append(("branch5", ASPPAvgBranch(in_channels, mid,
                                                  upscale_out_size)))
        self.branches = Concurrent(branches)
        self.conv = conv1x1_block(5 * mid, mid)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x):
        return self.dropout(self.conv(self.branches(x)))


class DeepLabv3(SegmentationHead):
    """DeepLabv3 (JAX ``models/deeplabv3.py:97``): ASPP, then the final
    block at a bottleneck factor of 1; the aux block at 4."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 2048,
                 aux: bool = False, in_size: Tuple[int, int] = (480, 480),
                 in_channels: int = 3, num_classes: int = 21):
        pool_out_size = (in_size[0] // 8, in_size[1] // 8)
        super().__init__(
            backbone,
            AtrousSpatialPyramidPooling(backbone_out_channels, pool_out_size),
            DeepLabv3FinalBlock(backbone_out_channels // 8, num_classes, 1),
            DeepLabv3FinalBlock(backbone_out_channels // 2, num_classes, 4)
            if aux else None, in_size, in_channels, num_classes)


def _variant(name: str, blocks: int, num_classes: int):
    def ctor(num_classes: int = num_classes, aux: bool = True, **kwargs):
        return DeepLabv3(segmentation_backbone(blocks),
                         num_classes=num_classes, aux=aux, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _blocks, _classes in (
        ("deeplabv3_resnetd50b_voc", 50, 21),
        ("deeplabv3_resnetd101b_voc", 101, 21),
        ("deeplabv3_resnetd152b_voc", 152, 21),
        ("deeplabv3_resnetd50b_coco", 50, 21),
        ("deeplabv3_resnetd101b_coco", 101, 21),
        ("deeplabv3_resnetd152b_coco", 152, 21),
        ("deeplabv3_resnetd50b_ade20k", 50, 150),
        ("deeplabv3_resnetd101b_ade20k", 101, 150),
        ("deeplabv3_resnetd50b_cityscapes", 50, 19),
        ("deeplabv3_resnetd101b_cityscapes", 101, 19)):
    _variant(_name, _blocks, _classes)
