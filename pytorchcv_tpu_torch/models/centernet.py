"""CenterNet (NCHW), with the reference pytorchcv module names. Counterpart
of ``pytorchcv_tpu.models.centernet``: the same 6 registered names. The
plain ResNet trunk without its pool, three conv + x2 deconv units, the
heatmap, size and offset heads (the heatmap head keeps the reference's
spelling, ``heapmap_block``) and the top-k box decode."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import (Concurrent, DeconvBlock, Sequential, conv1x1,
                  conv3x3_block)
from .registry import register_model
from .simplepose_coco import plain_trunk

__all__ = ["CenterNetDecoderUnit", "CenterNetHeadBlock",
           "CenterNetHeatmapBlock", "CenterNet", "centernet_heatmap_max_det"]


class CenterNetDecoderUnit(nn.Module):
    """3x3 conv block with bias, then a 4x4/2 deconv block (JAX
    ``models/centernet.py:27``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = conv3x3_block(in_channels, out_channels, bias=True)
        self.deconv = DeconvBlock(out_channels, out_channels)

    def forward(self, x):
        return self.deconv(self.conv(x))


class CenterNetHeadBlock(nn.Module):
    """3x3 conv with bias and ReLU (no BN), then a 1x1 conv with bias (JAX
    ``models/centernet.py:42``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = conv3x3_block(in_channels, in_channels, bias=True,
                                   normalization=False)
        self.conv2 = conv1x1(in_channels, out_channels, bias=True)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class CenterNetHeatmapBlock(nn.Module):
    """The class heatmap: head, sigmoid, then with ``do_nms`` the 3x3
    max-pool suppression ``x * (maxpool(x) == x)``, without it a clip to
    [1e-4, 1 - 1e-4] (JAX ``models/centernet.py:57``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 do_nms: bool = True):
        super().__init__()
        self.head = CenterNetHeadBlock(in_channels, out_channels)
        self.do_nms = do_nms

    def forward(self, x):
        x = torch.sigmoid(self.head(x))
        if self.do_nms:
            y = F.max_pool2d(x, 3, stride=1, padding=1)
            return x * (y == x).to(x.dtype)
        return x.clamp(1e-4, 1.0 - 1e-4)


def centernet_heatmap_max_det(x: torch.Tensor, topk: int = 40,
                              scale: int = 4) -> torch.Tensor:
    """The top-k box decode (JAX ``models/centernet.py:74``): ``x`` NCHW
    (B, classes + 4, H, W) of [heatmap | wh | reg] -> (B, topk, 6) f32 of
    (x1, y1, x2, y2, class, score), ranked over all classes and pixels
    (channel-major), ties by the lower flat index as ``jax.lax.top_k``
    ranks them (``torch.topk`` promises no order among equal values: a
    stable descending sort)."""
    heatmap, wh, reg = x[:, :-4], x[:, -4:-2], x[:, -2:]
    b, _, h, w = heatmap.shape
    scores, indices = torch.sort(heatmap.reshape(b, -1), dim=-1,
                                 descending=True, stable=True)
    scores, indices = scores[:, :topk], indices[:, :topk]
    classes = (indices // (h * w)).to(torch.float32)
    pix = indices % (h * w)
    ys = (pix // w).to(torch.float32)
    xs = (pix % w).to(torch.float32)

    def at(t, c):
        return torch.gather(t[:, c].reshape(b, -1), 1, pix)

    xs = xs + at(reg, 0)
    ys = ys + at(reg, 1)
    bw, bh = at(wh, 0), at(wh, 1)
    boxes = torch.stack((xs - 0.5 * bw, ys - 0.5 * bh, xs + 0.5 * bw,
                         ys + 0.5 * bh), dim=-1) * scale
    return torch.cat([boxes, classes[..., None],
                      scores[..., None].to(torch.float32)], dim=-1)


class CenterNet(nn.Module):
    """CenterNet (JAX ``models/centernet.py:110``): backbone -> ``decoder``
    (``unit1..3``, then ``heads``: heatmap, size and offset concatenated on
    channels) -> with ``return_heatmap`` that (B, classes + 4, H/4, W/4)
    tensor (the heatmap clipped, not suppressed), else its ``topk`` boxes
    (B, topk, 6). ``forward(x, from_features=True)`` takes the backbone's
    output, the head-only entry of the int8 serving pipeline."""

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 512,
                 channels: Sequence[int] = (256, 128, 64),
                 return_heatmap: bool = False, topk: int = 40,
                 in_size: Tuple[int, int] = (512, 512), in_channels: int = 3,
                 num_classes: int = 80):
        super().__init__()
        self.backbone = backbone
        units, c_in = [], backbone_out_channels
        for i, c in enumerate(channels):
            units.append((f"unit{i + 1}", CenterNetDecoderUnit(c_in, c)))
            c_in = c
        units.append(("heads", Concurrent([
            ("heapmap_block", CenterNetHeatmapBlock(
                c_in, num_classes, do_nms=not return_heatmap)),
            ("wh_block", CenterNetHeadBlock(c_in, 2)),
            ("reg_block", CenterNetHeadBlock(c_in, 2))])))
        self.decoder = Sequential(units)
        self.topk = topk
        self.in_size = tuple(in_size)
        self.in_channels = in_channels
        self.num_classes = num_classes

    @property
    def return_heatmap(self) -> bool:
        return not self.decoder.heads.heapmap_block.do_nms

    @return_heatmap.setter
    def return_heatmap(self, value: bool) -> None:
        self.decoder.heads.heapmap_block.do_nms = not value

    def forward(self, x, from_features: bool = False):
        x = self.decoder(x if from_features else self.backbone(x))
        if self.return_heatmap:
            return x
        return centernet_heatmap_max_det(x, self.topk, scale=4)


def _variant(name: str, blocks: int, num_classes: int):
    def ctor(num_classes: int = num_classes, **kwargs):
        return CenterNet(plain_trunk(blocks, conv1_stride=(blocks == 18)),
                         512 if blocks == 18 else 2048,
                         num_classes=num_classes, **kwargs)
    ctor.__name__ = name
    register_model(name)(ctor)


for _blocks, _tag in ((18, "resnet18"), (50, "resnet50b"),
                      (101, "resnet101b")):
    for _ds, _nc in (("voc", 20), ("coco", 80)):
        _variant(f"centernet_{_tag}_{_ds}", _blocks, _nc)
