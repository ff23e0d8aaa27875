"""PSPNet (NCHW) and the segmentation backbone shared by the dense-prediction
heads, with the reference pytorchcv module names. Counterpart of
``pytorchcv_tpu.models.pspnet``: the same 8 registered names. The head
reads the backbone's stage-3 "bend" only with ``aux``."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from torch import nn

from ..nn import (Concurrent, MultiOutputSequential, conv1x1, conv1x1_block,
                  conv3x3_block, interpolate, positional_layers)
from .registry import register_model
from .resnetd import _LAYERS, resnetd_features

__all__ = ["segmentation_backbone", "PSPFinalBlock", "PyramidPoolingBranch",
           "PyramidPooling", "PSPNet", "SegmentationHead"]


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


class PSPFinalBlock(nn.Module):
    """3x3 conv block to ``in / bottleneck_factor`` -> dropout -> 1x1 conv
    with bias -> bilinear (align corners) up to ``out_size`` (JAX
    ``models/pspnet.py:41``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_factor: int = 4):
        super().__init__()
        if in_channels % bottleneck_factor:
            raise ValueError(f"{in_channels} channels do not divide by "
                             f"{bottleneck_factor}")
        mid = in_channels // bottleneck_factor
        self.conv1 = conv3x3_block(in_channels, mid)
        self.dropout = nn.Dropout(0.1)
        self.conv2 = conv1x1(mid, out_channels, bias=True)

    def forward(self, x, out_size: Tuple[int, int]):
        return interpolate(self.conv2(self.dropout(self.conv1(x))), out_size)


class PyramidPoolingBranch(nn.Module):
    """Adaptive average pool to ``pool_out_size`` -> 1x1 conv block ->
    bilinear up to ``upscale_out_size`` (the input's size when None) (JAX
    ``models/pspnet.py:70``). JAX's ``adaptive_avg_pool2d`` (``nn/ops.py:
    361``) averages the windows ``[floor(i m / n), ceil((i + 1) m / n))``,
    as ``nn.AdaptiveAvgPool2d`` does, also where n does not divide m."""

    def __init__(self, in_channels: int, out_channels: int,
                 pool_out_size: int,
                 upscale_out_size: Optional[Tuple[int, int]]):
        super().__init__()
        self.upscale_out_size = upscale_out_size
        self.pool = nn.AdaptiveAvgPool2d(pool_out_size)
        self.conv = conv1x1_block(in_channels, out_channels)

    def forward(self, x):
        size = self.upscale_out_size or tuple(x.shape[2:])
        return interpolate(self.conv(self.pool(x)), size)


class PyramidPooling(nn.Module):
    """The input (``nn.Identity``, JAX ``nn/ops.py:33``) and four pooled
    branches (1, 2, 3 and 6 bins), concatenated on channels (JAX
    ``models/pspnet.py:93``, whose ``Concurrent`` scope ``pool.branches``
    is the port's ``pool`` -> ``branches``)."""

    def __init__(self, in_channels: int,
                 upscale_out_size: Optional[Tuple[int, int]]):
        super().__init__()
        mid = in_channels // 4
        branches = [("branch1", nn.Identity())]
        for i, size in enumerate((1, 2, 3, 6)):
            branches.append((f"branch{i + 2}", PyramidPoolingBranch(
                in_channels, mid, size, upscale_out_size)))
        self.branches = Concurrent(branches)

    def forward(self, x):
        return self.branches(x)


class SegmentationHead(nn.Module):
    """The shell of PSPNet, DeepLabv3 and FCN-8s(d): the backbone, a
    ``pool`` (None for FCN-8s(d)), ``final_block`` on stage 4 and, with
    ``aux``, ``aux_block`` on the stage-3 bend, both maps at the fixed
    ``in_size``. ``forward(outs, from_features=True)`` takes the backbone's
    ``(stage4, bend)`` (NCHW; the bend None without ``aux``), the head-only
    entry of the int8 serving pipeline."""

    def __init__(self, backbone: nn.Module, pool: Optional[nn.Module],
                 final_block: nn.Module, aux_block: Optional[nn.Module],
                 in_size: Tuple[int, int], in_channels: int,
                 num_classes: int):
        super().__init__()
        self.backbone = backbone
        if pool is not None:
            self.pool = pool
        self.final_block = final_block
        self.aux = aux_block is not None
        if self.aux:
            self.aux_block = aux_block
        self.in_size = tuple(in_size)
        self.in_channels = in_channels
        self.num_classes = num_classes

    @property
    def reads_bend(self) -> bool:
        """Whether the head takes the backbone's stage-3 output."""
        return self.aux

    def forward(self, x, from_features: bool = False):
        outs = x if from_features else self.backbone(x)
        x = outs[0]
        if hasattr(self, "pool"):
            x = self.pool(x)
        x = self.final_block(x, self.in_size)
        if self.aux:
            return x, self.aux_block(outs[1], self.in_size)
        return x


class PSPNet(SegmentationHead):
    """PSPNet (JAX ``models/pspnet.py:112``): pyramid pooling, then the final
    block at a bottleneck factor of 8; the aux block at 4."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 2048,
                 aux: bool = False, in_size: Tuple[int, int] = (480, 480),
                 in_channels: int = 3, num_classes: int = 21):
        pool_out_size = (in_size[0] // 8, in_size[1] // 8)
        super().__init__(
            backbone, PyramidPooling(backbone_out_channels, pool_out_size),
            PSPFinalBlock(2 * backbone_out_channels, num_classes, 8),
            PSPFinalBlock(backbone_out_channels // 2, num_classes, 4)
            if aux else None, in_size, in_channels, num_classes)


def _variant(name: str, blocks: int, num_classes: int):
    def ctor(num_classes: int = num_classes, aux: bool = True, **kwargs):
        return PSPNet(segmentation_backbone(blocks), num_classes=num_classes,
                      aux=aux, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _name, _blocks, _classes in (
        ("pspnet_resnetd50b_voc", 50, 21), ("pspnet_resnetd101b_voc", 101, 21),
        ("pspnet_resnetd50b_coco", 50, 21),
        ("pspnet_resnetd101b_coco", 101, 21),
        ("pspnet_resnetd50b_ade20k", 50, 150),
        ("pspnet_resnetd101b_ade20k", 101, 150),
        ("pspnet_resnetd50b_cityscapes", 50, 19),
        ("pspnet_resnetd101b_cityscapes", 101, 19)):
    _variant(_name, _blocks, _classes)
