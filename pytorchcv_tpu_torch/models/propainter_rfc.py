"""ProPainter recurrent flow completion (RFC), NCHW/NCDHW. Counterpart of
``pytorchcv_tpu.models.propainter_rfc`` (reference pytorchcv
``models/propainter_rfc.py``), from 'ProPainter: Improving Propagation and
Transformer for Video Inpainting', https://arxiv.org/abs/2309.03897.

Layouts follow PyTorch's channels-first idiom: video tensors are
(B, T, C, H, W), the 3-D encoder works on (B, C, T, H, W), the decoder on
(B*T, C, H, W), and clip flows are (T, 4, H, W). The second-order
deformable alignment runs ``nn.deform.deform_conv2d`` with its
bounded-offset contract, so at batch 1 on the card it samples with K5
(``csrc/deform_sample.cu``). The per-frame recurrence is a Python loop, as
in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn import (BreakBlock, Hourglass, InterpolationBlock, Sequential,
                  conv1x1, conv3x3_block, create_activation,
                  lambda_leakyrelu)
from ..nn.activ import Activation
from ..nn.deform import deform_conv2d
from .registry import register_model
from .resnet import ResBlock, ResUnit

__all__ = ["PPRecurrentFlowComplete", "get_propainter_rfc",
           "calc_bidirectional_opt_flow_completion_by_pprfc",
           "SecondOrderDeformableAlignment", "RFCBidirectionalPropagation",
           "ConvBlock3d"]


class DeformConv(nn.Conv2d):
    """Modulated deformable conv: torchvision ``DeformConv2d``'s ``weight``
    (O, C, 3, 3) and ``bias``, applied by ``deform_conv2d``."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 16):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.deform_groups = deform_groups

    def forward(self, x, offset, mask, center=None, residue_bound=None):
        return deform_conv2d(x, offset, mask, self.weight, self.bias,
                             stride=1, padding=1,
                             deform_groups=self.deform_groups, center=center,
                             residue_bound=residue_bound)


class SecondOrderDeformableAlignment(nn.Module):
    """Offsets and mask from ``cond``, then a deformable conv of ``x``
    (JAX ``propainter_rfc.py:60``). ``conv_offset``: cond -> C -> C -> C ->
    27*G, LeakyReLU 0.1 between; offsets ``mag * tanh(.)`` (plus the (y, x)
    flow when given, which is then also the center), mask ``sigmoid(.)``."""

    def __init__(self, in_channels: int, cond_channels: int,
                 out_channels: int, deform_groups: int = 16,
                 max_residue_magnitude: int = 5):
        super().__init__()
        widths = (cond_channels, out_channels, out_channels, out_channels,
                  27 * deform_groups)
        self.conv_offset = Sequential([
            (f"conv{i + 1}", conv3x3_block(
                widths[i], widths[i + 1], bias=True, normalization=False,
                activation=lambda_leakyrelu(0.1) if i < 3 else None))
            for i in range(4)])
        self.deform_conv = DeformConv(in_channels, out_channels,
                                      deform_groups)
        self.max_residue_magnitude = max_residue_magnitude

    def forward(self, x, cond, flow: Optional[torch.Tensor] = None):
        o1, o2, mask = torch.chunk(self.conv_offset(cond), 3, dim=1)
        offset = self.max_residue_magnitude * torch.tanh(
            torch.cat([o1, o2], dim=1))
        if flow is not None:
            center = flow.flip(1)           # flow is (x, y); offsets (y, x)
            offset = offset + center.repeat(1, offset.shape[1] // 2, 1, 1)
        else:
            center = x.new_zeros((x.shape[0], 2, *x.shape[2:]))
        return self.deform_conv(x, offset, torch.sigmoid(mask), center=center,
                                residue_bound=float(
                                    self.max_residue_magnitude))


class RFCBidirectionalPropagation(nn.Module):
    """Second-order bidirectional feature propagation (JAX
    ``propainter_rfc.py:108``): (B, T, C, H, W) -> (B, T, C, H, W). The
    backward pass runs first; frame i > 1 of a pass is aligned on the
    features of frames i-1 and i-2 of that pass."""

    _DIRS = ("backward_", "forward_")

    def __init__(self, channels: int = 128):
        super().__init__()
        c = channels
        act = lambda_leakyrelu(0.1)
        self.deform_align = nn.ModuleDict({
            d: SecondOrderDeformableAlignment(2 * c, 3 * c, c)
            for d in self._DIRS})
        # the forward pass also reads the backward pass's features
        self.backbone = nn.ModuleDict({
            d: ResBlock((2 + i) * c, c, 1, bias=True, normalization=False,
                        activation=act)
            for i, d in enumerate(self._DIRS)})
        self.fusion = conv1x1(2 * c, c, bias=True)

    def forward(self, x):
        b, t, c, h, w = x.shape
        feats = {"spatial": [x[:, i] for i in range(t)]}
        for d in self._DIRS:
            feats[d] = []
            frames = range(t - 1, -1, -1) if d == "backward_" else range(t)
            feat_prop = x.new_zeros((b, c, h, w))
            for i, idx in enumerate(frames):
                feat_current = feats["spatial"][idx]
                if i > 0:
                    feat_n2 = feats[d][-2] if i > 1 else \
                        torch.zeros_like(feat_prop)
                    cond = torch.cat([feat_prop, feat_current, feat_n2], 1)
                    feat_prop = self.deform_align[d](
                        torch.cat([feat_prop, feat_n2], 1), cond)
                feat = torch.cat(
                    [feat_current] + [feats[k][idx] for k in feats
                                      if k not in ("spatial", d)]
                    + [feat_prop], 1)
                feat_prop = feat_prop + self.backbone[d](feat)
                feats[d].append(feat_prop)
            if d == "backward_":
                feats[d] = feats[d][::-1]
        out = [self.fusion(torch.cat([feats[d][i] for d in self._DIRS], 1))
               for i in range(t)]
        return torch.stack(out, 1) + x


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


class ConvBlock3d(nn.Module):
    """``nn.Conv3d`` with bias (NCDHW) + activation (JAX
    ``propainter_rfc.py:179``); ``padding_mode="replicate"`` pads with the
    edge values."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=1,
                 stride=1, padding=0, dilation=1,
                 padding_mode: str = "zeros", activation: Activation = True):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, _triple(kernel_size),
                              stride=_triple(stride), padding=_triple(padding),
                              dilation=_triple(dilation),
                              padding_mode=padding_mode)
        self.activ = create_activation(activation)

    def forward(self, x):
        x = self.conv(x)
        return x if self.activ is None else self.activ(x)


def conv1x3x3_block(in_channels: int, out_channels: int,
                    padding=(0, 1, 1), **kwargs) -> ConvBlock3d:
    return ConvBlock3d(in_channels, out_channels, (1, 3, 3), padding=padding,
                       **kwargs)


class P3dBlock(nn.Module):
    """A (1, 3, 3) conv, then a (3, 1, 1) conv dilated 2 in time (JAX
    ``propainter_rfc.py:239``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 activation: Activation, final_activation: Activation):
        super().__init__()
        self.conv1 = conv1x3x3_block(in_channels, out_channels,
                                     stride=(1, stride, stride),
                                     activation=activation)
        self.conv2 = ConvBlock3d(out_channels, out_channels, (3, 1, 1),
                                 padding=(2, 0, 0), dilation=(2, 1, 1),
                                 activation=final_activation)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class DilationBlock(nn.Module):
    """Three (1, 3, 3) convs dilated 3, 2, 1 in space (JAX
    ``propainter_rfc.py:261``)."""

    def __init__(self, channels: int, activation: Activation):
        super().__init__()
        for i, d in enumerate((3, 2, 1)):
            self.add_module(f"conv{i + 1}", conv1x3x3_block(
                channels, channels, padding=(0, d, d), dilation=(1, d, d),
                activation=activation))

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class RFCDecoderUnit(nn.Module):
    """conv, x2 bilinear upsampling, conv on (B*T, C, H, W) (JAX
    ``propainter_rfc.py:278``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: Activation, final_activation: Activation):
        super().__init__()
        self.conv1 = conv3x3_block(in_channels, in_channels, bias=True,
                                   normalization=False, activation=activation)
        self.up = InterpolationBlock(scale_factor=2)
        self.conv2 = conv3x3_block(in_channels, out_channels, bias=True,
                                   normalization=False,
                                   activation=final_activation)

    def forward(self, x):
        return self.conv2(self.up(self.conv1(x)))


class EdgeDetection(nn.Module):
    """proj conv, residual unit, 1x1 conv, sigmoid (JAX
    ``propainter_rfc.py:299``)."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 mid_channels: int = 16,
                 activation: Activation = lambda_leakyrelu(0.2),
                 final_activation: Activation = lambda_leakyrelu(0.01)):
        super().__init__()
        self.proj = conv3x3_block(in_channels, mid_channels, bias=True,
                                  normalization=False, activation=activation)
        self.res_unit = ResUnit(mid_channels, mid_channels, 1,
                                bottleneck=False, conv1_stride=False,
                                bias=True, normalization=False,
                                activation=activation,
                                final_activation=final_activation)
        self.out_conv = conv1x1(mid_channels, out_channels, bias=True)

    def forward(self, x):
        return torch.sigmoid(self.out_conv(self.res_unit(self.proj(x))))


class EncoderUnit(nn.Module):
    """Two P3D blocks, the second strided 2 in space (JAX
    ``propainter_rfc.py:323``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: Activation):
        super().__init__()
        self.block1 = P3dBlock(in_channels, in_channels, 1, activation,
                               activation)
        self.block2 = P3dBlock(in_channels, out_channels, 2, activation,
                               activation)

    def forward(self, x):
        return self.block2(self.block1(x))


class InitBlock(nn.Module):
    """(1, 5, 5)/2 replicate-padded conv (JAX ``propainter_rfc.py:342``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: Activation):
        super().__init__()
        self.conv = ConvBlock3d(in_channels, out_channels, (1, 5, 5),
                                stride=(1, 2, 2), padding=(0, 2, 2),
                                padding_mode="replicate",
                                activation=activation)

    def forward(self, x):
        return self.conv(x)


def _frames_into_batch(x):
    """(B, C, T, H, W) -> (B*T, C, H, W)."""
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


class MainUnit(nn.Module):
    """Dilation stack, then the bidirectional propagation; time goes into
    the batch for the decoder (JAX ``propainter_rfc.py:359``)."""

    def __init__(self, channels: int, activation: Activation):
        super().__init__()
        self.mid_dilation = DilationBlock(channels, activation)
        self.feat_prop_module = RFCBidirectionalPropagation(channels)

    def forward(self, x):
        x = self.mid_dilation(x).transpose(1, 2)
        x = self.feat_prop_module(x)
        b, t, c, h, w = x.shape
        return x.reshape(b * t, c, h, w)


class ReshapeBlock(nn.Module):
    """The hourglass's third skip: (B, C, T, H, W) -> (B*T, C, H, W) (JAX
    ``propainter_rfc.py:378``)."""

    def forward(self, x):
        return _frames_into_batch(x)


class PPRecurrentFlowComplete(nn.Module):
    """ProPainter RFC (JAX ``propainter_rfc.py:388``).

    ``forward(masked_flows (B, T, 2, H, W), masks (B, T, 1, H, W))`` ->
    (completed flows (B, T, 2, H, W), edge maps (B, T, 1, H, W) or None);
    H and W divisible by 8. The edge detector always exists (its parameters
    are in every checkpoint) and runs only with ``calc_edge``."""

    def __init__(self, calc_edge: bool = False, in_channels: int = 3,
                 in_size: Tuple[int, int] = (240, 432)):
        super().__init__()
        self.calc_edge = calc_edge
        self.in_channels = in_channels
        self.in_size = tuple(in_size)
        act = lambda_leakyrelu(0.2)
        self.hg = Hourglass(
            down_seq=[("down1", InitBlock(in_channels, 32, act)),
                      ("down2", EncoderUnit(32, 64, act)),
                      ("down3", EncoderUnit(64, 128, act))],
            up_seq=[("up1", RFCDecoderUnit(32, 2, act, None)),
                    ("up2", RFCDecoderUnit(64, 32, act, act)),
                    ("up3", RFCDecoderUnit(128, 64, act, act))],
            skip_seq=[("skip1", BreakBlock()), ("skip2", BreakBlock()),
                      ("skip3", ReshapeBlock()),
                      ("skip4", MainUnit(128, act))])
        self.edgeDetector = EdgeDetection(2, 1, 16, act,
                                          lambda_leakyrelu(0.01))

    def forward(self, masked_flows, masks):
        b, t, c, h, w = masked_flows.shape
        if c != 2 or h % 8 or w % 8:
            raise ValueError(f"PPRecurrentFlowComplete: flows must be "
                             f"(B, T, 2, H, W) with H, W divisible by 8, "
                             f"got {tuple(masked_flows.shape)}")
        x = torch.cat([masked_flows, masks], dim=2).transpose(1, 2)
        flow = self.hg(x)
        edge = self.edgeDetector(flow).view(b, t, 1, h, w) \
            if self.calc_edge else None
        return flow.view(b, t, 2, h, w), edge


def get_propainter_rfc(**kwargs) -> PPRecurrentFlowComplete:
    return PPRecurrentFlowComplete(**kwargs)


@register_model("propainter_rfc")
def propainter_rfc(**kwargs):
    return get_propainter_rfc(**kwargs)


def calc_bidirectional_opt_flow_completion_by_pprfc(
        model, flows: torch.Tensor, flow_masks: torch.Tensor,
        combine_flows: bool = True):
    """Complete a clip's forward and backward flows (JAX
    ``propainter_rfc.py:457``). ``model(masked_flows, masks)`` is an RFC;
    ``flows`` (T, 4, H, W) are (forward, backward), ``flow_masks``
    (T, 2, H, W). The backward flows run through the model in reversed
    time. Returns (completed flows (T, 4, H, W), edges (T, 2, H, W) or
    None)."""
    masks_f, masks_b = flow_masks[:, :1], flow_masks[:, 1:]
    masked_f = flows[:, :2] * (1 - masks_f)
    masked_b = flows[:, 2:] * (1 - masks_b)
    comp_f, edges_f = model(masked_f[None], masks_f[None])
    comp_b, edges_b = model(masked_b.flip(0)[None], masks_b.flip(0)[None])
    comp_f, comp_b = comp_f[0], comp_b[0].flip(0)
    if combine_flows:
        comp_f = comp_f * masks_f + masked_f
        comp_b = comp_b * masks_b + masked_b
    edges = None
    if edges_f is not None:
        edges = torch.cat([edges_f[0], edges_b[0].flip(0)], dim=1)
    return torch.cat([comp_f, comp_b], dim=1), edges
