"""FCN-8s(d) (NCHW), with the reference pytorchcv module names. Counterpart
of ``pytorchcv_tpu.models.fcn8sd``: the same 8 registered names. The head
reads the backbone's stage-3 "bend" only with ``aux``."""

from __future__ import annotations

from typing import Tuple

from torch import nn

from .pspnet import PSPFinalBlock, SegmentationHead, segmentation_backbone
from .registry import register_model

__all__ = ["FCNFinalBlock", "FCN8sd"]


# 3x3 conv block -> dropout -> 1x1 conv -> bilinear up (JAX
# models/fcn8sd.py:15): PSPNet's final block.
FCNFinalBlock = PSPFinalBlock


class FCN8sd(SegmentationHead):
    """FCN-8s(d) (JAX ``models/fcn8sd.py:39``): the final block straight on
    stage 4, the aux block on the bend, both at a bottleneck factor of 4."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 2048,
                 aux: bool = False, in_size: Tuple[int, int] = (480, 480),
                 in_channels: int = 3, num_classes: int = 21):
        super().__init__(
            backbone, None, FCNFinalBlock(backbone_out_channels, num_classes),
            FCNFinalBlock(backbone_out_channels // 2, num_classes)
            if aux else None, in_size, in_channels, num_classes)


def _variant(name: str, blocks: int, num_classes: int):
    def ctor(num_classes: int = num_classes, aux: bool = True, **kwargs):
        return FCN8sd(segmentation_backbone(blocks), num_classes=num_classes,
                      aux=aux, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _blocks, _classes in (
        ("fcn8sd_resnetd50b_voc", 50, 21), ("fcn8sd_resnetd101b_voc", 101, 21),
        ("fcn8sd_resnetd50b_coco", 50, 21),
        ("fcn8sd_resnetd101b_coco", 101, 21),
        ("fcn8sd_resnetd50b_ade20k", 50, 150),
        ("fcn8sd_resnetd101b_ade20k", 101, 150),
        ("fcn8sd_resnetd50b_cityscapes", 50, 19),
        ("fcn8sd_resnetd101b_cityscapes", 101, 19)):
    _variant(_name, _blocks, _classes)
