"""DANet for Cityscapes (NCHW), with the reference pytorchcv module names
(``backbone.1.unit1.body.conv1.conv.weight``, ``head.branch_pa.att.
query_conv.weight``, ...). Counterpart of ``pytorchcv_tpu.models.danet``:
the same two registered names. The position attention runs on the flash
attention kernel (K4)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from ..nn import conv1x1, conv3x3_block, interpolate
from .pspnet import segmentation_backbone
from .registry import register_model

__all__ = ["DANet", "ScaleBlock", "PosAttBlock", "ChaAttBlock",
           "DANetHeadBranch", "DANetHead"]


class ScaleBlock(nn.Module):
    """Learnable scalar gain, zero at init (reference danet.py:15)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.alpha * x


class PosAttBlock(nn.Module):
    """Position self-attention over H*W (reference danet.py:44)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        mid = channels // reduction
        self.query_conv = conv1x1(channels, mid, bias=True)
        self.key_conv = conv1x1(channels, mid, bias=True)
        self.value_conv = conv1x1(channels, channels, bias=True)
        self.scale = ScaleBlock()

    def forward(self, x):
        b, c, h, w = x.shape

        def tokens(t):           # (B, C', H, W) -> (B, H*W, C')
            return t.flatten(2).transpose(1, 2).contiguous()

        y = flash_attention(tokens(self.query_conv(x)),
                            tokens(self.key_conv(x)),
                            tokens(self.value_conv(x)), 1.0)
        y = y.to(x.dtype).transpose(1, 2).reshape(b, c, h, w)
        return self.scale(y) + x


class ChaAttBlock(nn.Module):
    """Channel gram self-attention (reference danet.py:99)."""

    def __init__(self):
        super().__init__()
        self.scale = ScaleBlock()

    def forward(self, x):
        b, c, h, w = x.shape
        f = x.reshape(b, c, h * w)
        energy = torch.bmm(f, f.transpose(1, 2))
        energy_new = energy.amax(dim=-1, keepdim=True) - energy
        wgt = torch.softmax(energy_new, dim=-1)
        y = torch.bmm(wgt, f).reshape(b, c, h, w)
        return self.scale(y) + x


class DANetHeadBranch(nn.Module):
    """conv -> attention -> conv -> classifier (reference danet.py:140);
    returns the classes and the features before the classifier."""

    def __init__(self, in_channels: int, out_channels: int,
                 pose_att: bool = True):
        super().__init__()
        mid = in_channels // 4
        self.conv1 = conv3x3_block(in_channels, mid)
        self.att = PosAttBlock(mid) if pose_att else ChaAttBlock()
        self.conv2 = conv3x3_block(mid, mid)
        self.conv3 = conv1x1(mid, out_channels, bias=True)

    def forward(self, x):
        y = self.conv2(self.att(self.conv1(x)))
        return self.conv3(y), y


class DANetHead(nn.Module):
    """Dual-branch head (reference danet.py:191)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.branch_pa = DANetHeadBranch(in_channels, out_channels, True)
        self.branch_ca = DANetHeadBranch(in_channels, out_channels, False)
        self.conv = conv1x1(in_channels // 4, out_channels, bias=True)

    def forward(self, x):
        pa_x, pa_y = self.branch_pa(x)
        ca_x, ca_y = self.branch_ca(x)
        return self.conv(pa_y + ca_y), pa_x, ca_x


class DANet(nn.Module):
    """DANet (reference danet.py:238). ``forward(x)`` takes an NCHW image;
    ``forward(outs, from_features=True)`` takes the backbone's
    ``(stage4, bend)`` (NCHW), the head-only entry of the int8 serving
    pipeline. Returns the class map at the fixed ``in_size`` (and the two
    branch maps with ``aux``)."""

    reads_bend = False          # the head takes stage 4 only

    def __init__(self, backbone: nn.Module, backbone_out_channels: int = 2048,
                 aux: bool = False, in_size: Tuple[int, int] = (480, 480),
                 in_channels: int = 3, num_classes: int = 19):
        super().__init__()
        self.backbone = backbone
        self.head = DANetHead(backbone_out_channels, num_classes)
        self.aux = aux
        self.in_size = tuple(in_size)
        self.in_channels = in_channels
        self.num_classes = num_classes

    def forward(self, x, from_features: bool = False):
        outs = x if from_features else self.backbone(x)
        x, y, z = self.head(outs[0])
        x = interpolate(x, self.in_size)
        if self.aux:
            return (x, interpolate(y, self.in_size),
                    interpolate(z, self.in_size))
        return x


@register_model("danet_resnetd50b_cityscapes")
def danet_resnetd50b_cityscapes(num_classes: int = 19, aux: bool = True,
                                **kwargs) -> DANet:
    return DANet(segmentation_backbone(50, bends=(3,)), aux=aux,
                 num_classes=num_classes, **kwargs)


@register_model("danet_resnetd101b_cityscapes")
def danet_resnetd101b_cityscapes(num_classes: int = 19, aux: bool = True,
                                 **kwargs) -> DANet:
    return DANet(segmentation_backbone(101, bends=(3,)), aux=aux,
                 num_classes=num_classes, **kwargs)
