"""RAFT optical flow (NCHW), counterpart of ``pytorchcv_tpu.models.raft``
(reference pytorchcv ``models/raft.py``), with its module and parameter
names, so that ``zoo.convert.load_jax_variables`` carries the JAX
package's variables over.

As in the JAX package, the all-pairs correlation volume is one (B, HW, HW)
product, and the radius-r window lookup at every pyramid level is two
banded one-hot products a pixel (``lookup_corr``); ``lookup_corr_gather``
is the ``grid_sample`` formulation the reference runs, kept as its oracle.
No Pallas kernel stands behind any of it: the products run on cuBLAS and
the convolutions on cuDNN, in f32 with TF32 off (``get_model``'s
``_pin_f32``).

The reference quirk is kept: the window's row offset is added to the x
coordinate and its column offset to y. The offset grids are symmetric, so
the sampled set is the reference's, and each level's (2r+1)^2 channels have
the x offset as the slow axis; the converted ``conv_corr`` weights read
them in that order.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import (ConvBlock, Sequential, conv1x1, conv3x3_block,
                  conv7x7_block, grid_sample, interpolate, lambda_sigmoid,
                  lambda_tanh)
from ..nn.conv import Normalization
from ..nn.norm import lambda_instancenorm2d
from .inceptionv3 import ConvSeqBranch
from .registry import register_model
from .resnet import ResUnit

__all__ = ["RAFT", "RAFTEncoder", "RAFTMotionEncoder", "ConvGRU",
           "SepConvGRU", "FlowHead", "MaskHead", "RAFTUpdateBlock",
           "get_raft", "create_coords_grid", "upsample_flow_using_mask",
           "upsample_flow_using_interpolation", "build_corr_pyramid",
           "lookup_corr", "lookup_corr_gather",
           "calc_bidirectional_optical_flow_on_video_by_raft"]


def create_coords_grid(batch: int, height: int, width: int,
                       device=None) -> torch.Tensor:
    """Pixel coordinates (B, 2, H, W), channels (x, y) (JAX
    ``raft.py:50``)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs, ys])[None].expand(batch, 2, height, width)


def upsample_flow_using_mask(flow: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling (JAX ``raft.py:60``): ``flow`` (B,
    2, h, w), ``mask`` (B, 9 * 8 * 8, h, w) with channels factored as
    (neighbour, up_row, up_col), neighbours in unfold's (ky, kx) row-major
    order; the softmax over the 9 neighbours weighs 8 x flow at the 3x3
    neighbours. Returns (B, 2, 8h, 8w)."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 9, 8, 8, h, w), dim=1)
    fp = F.pad(8.0 * flow, (1, 1, 1, 1))
    neigh = torch.stack([fp[:, :, ky:ky + h, kx:kx + w]
                         for ky in range(3) for kx in range(3)], dim=2)
    up = torch.einsum("bnuvhw,bcnhw->bchuwv", m, neigh)
    return up.reshape(b, 2, 8 * h, 8 * w)


def upsample_flow_using_interpolation(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsampling of a flow, ``align_corners=True``, the
    displacements times 8 (JAX ``raft.py:79``)."""
    h, w = flow.shape[2:]
    return 8.0 * interpolate(flow, (8 * h, 8 * w), mode="bilinear",
                             align_corners=True)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation pyramid (JAX ``raft.py:86``): one (B, HW, HW)
    product of the two feature maps over sqrt(C), as (B HW, 1, H, W), then
    ``num_levels - 1`` average pools of 2x2, stride 2, that floor odd
    sizes."""
    b, c, h, w = fmap1.shape
    corr = torch.bmm(fmap1.reshape(b, c, h * w).transpose(1, 2),
                     fmap2.reshape(b, c, h * w)) / math.sqrt(c)
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def _centroids(coords: torch.Tensor) -> torch.Tensor:
    """(B, 2, h, w) coordinates as (B h w, 2) f32 rows."""
    return coords.permute(0, 2, 3, 1).reshape(-1, 2).to(torch.float32)


def lookup_corr(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Bilinear (2r+1)^2 windows of every pyramid level around ``coords``
    (B, 2, h, w), as the JAX package computes them (``raft.py:106``): the
    window of one pixel is Wy @ corr @ Wx^T, two banded one-hot products
    with the lerp weights in the bands,

        Wy[k, y] = (1 - wy) [y == y0 + k] + wy [y == y0 + k + 1],

    so that a tap off the level matches no column and adds zero, as
    ``grid_sample``'s zeros padding. Returns (B, levels (2r+1)^2, h, w),
    each level's channels with the x offset as the slow axis."""
    b, _, h, w = coords.shape
    ks = 2 * radius + 1
    n = b * h * w
    lin = torch.linspace(-radius, radius, ks, dtype=torch.float32,
                         device=coords.device)
    centroid = _centroids(coords)
    outs = []
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        cm = corr.reshape(n, hl, wl)
        c = centroid / (2.0 ** i)
        fx = c[:, 0, None] + lin
        fy = c[:, 1, None] + lin
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        wx = (fx - x0)[:, :, None]
        wy = (fy - y0)[:, :, None]
        ys = torch.arange(hl, dtype=torch.float32, device=coords.device)
        xs = torch.arange(wl, dtype=torch.float32, device=coords.device)
        wy_m = ((1.0 - wy) * (ys == y0[:, :, None]) +
                wy * (ys == y0[:, :, None] + 1.0)).to(cm.dtype)
        wx_m = ((1.0 - wx) * (xs == x0[:, :, None]) +
                wx * (xs == x0[:, :, None] + 1.0)).to(cm.dtype)
        rows = torch.bmm(wy_m, cm)                        # (n, ks_y, wl)
        win = torch.bmm(wx_m, rows.transpose(1, 2))       # (n, ks_x, ks_y)
        outs.append(win.reshape(b, h, w, ks * ks))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous()


def lookup_corr_gather(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """The reference's lookup (JAX ``raft.py:159``), the oracle of
    ``lookup_corr``: ``grid_sample`` (bilinear, ``align_corners=True``,
    zeros) of each level at the window's positions, the row offset added to
    x and the column offset to y. A level of width or height 1 divides by
    zero here, as in the reference."""
    b, _, h, w = coords.shape
    ks = 2 * radius + 1
    lin = torch.linspace(-radius, radius, ks, dtype=torch.float32,
                         device=coords.device)
    d0, d1 = torch.meshgrid(lin, lin, indexing="ij")
    centroid = _centroids(coords)[:, None, None, :]
    outs = []
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        c = centroid / (2.0 ** i)
        gx = c[..., 0] + d0
        gy = c[..., 1] + d1
        grid = torch.stack([2.0 * gx / (wl - 1) - 1.0,
                            2.0 * gy / (hl - 1) - 1.0], dim=-1)
        sampled = grid_sample(corr, grid, align_corners=True)
        outs.append(sampled.reshape(b, h, w, ks * ks))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous()


class RAFTEncoder(nn.Module):
    """Feature or context encoder (JAX ``raft.py:185``): a 7x7/2 conv block,
    three stages of residual units (stride 2 at the first unit of the
    second and third) whose bodies end in ReLU, and a 1x1 projection; 1/8
    of the input's size. ``normalization``: instance norm (the feature
    net), True BN or None (the context net). Dropout after it, off in eval
    mode."""

    def __init__(self, in_channels: int = 3, init_block_channels: int = 64,
                 mid_channels: Sequence[Sequence[int]] = (),
                 final_block_channels: int = 256, bottleneck: bool = False,
                 normalization: Normalization = True,
                 dropout_rate: float = 0.0):
        super().__init__()
        layers = [("init_block", conv7x7_block(
            in_channels, init_block_channels, stride=2, bias=True,
            normalization=normalization))]
        c_in = init_block_channels
        for i, stage_channels in enumerate(mid_channels):
            units = []
            for j, c_out in enumerate(stage_channels):
                stride = 2 if j == 0 and i != 0 else 1
                units.append((f"unit{j + 1}", ResUnit(
                    c_in, c_out, stride, bottleneck, conv1_stride=False,
                    bias=True, normalization=normalization,
                    final_body_activation=True)))
                c_in = c_out
            layers.append((f"stage{i + 1}", Sequential(units)))
        layers.append(("final_block", conv1x1(c_in, final_block_channels,
                                              bias=True)))
        self.features = Sequential(layers)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 \
            else None

    def forward(self, x):
        x = self.features(x)
        return x if self.dropout is None else self.dropout(x)


class RAFTMotionEncoder(nn.Module):
    """Convs over the correlation lookup (a 1x1, or a 1x1 and a 3x3) and
    over the flow (7x7, 3x3), fused by a 3x3 conv block and concatenated
    with the flow (JAX ``raft.py:223``)."""

    def __init__(self, corr_in_channels: int,
                 corr_out_channels_list: Sequence[int],
                 flow_out_channels_list: Sequence[int],
                 mout_out_channels: int = 126):
        super().__init__()
        if len(corr_out_channels_list) == 1:
            corr_ks, corr_pd = (1,), (0,)
        else:
            corr_ks, corr_pd = (1, 3), (0, 1)
        self.conv_corr = ConvSeqBranch(
            corr_in_channels, corr_out_channels_list, corr_ks,
            (1,) * len(corr_ks), corr_pd, bias=True, normalization=None)
        self.conv_flow = ConvSeqBranch(
            2, flow_out_channels_list, (7, 3), (1, 1), (3, 1), bias=True,
            normalization=None)
        self.conv_out = conv3x3_block(
            corr_out_channels_list[-1] + flow_out_channels_list[-1],
            mout_out_channels, bias=True, normalization=None)

    def forward(self, corr, flow):
        out = torch.cat([self.conv_corr(corr), self.conv_flow(flow)], dim=1)
        return torch.cat([self.conv_out(out), flow], dim=1)


class ConvGRU(nn.Module):
    """Convolutional GRU cell (JAX ``raft.py:255``): gates z and r
    (sigmoid) and the candidate q (tanh) are conv blocks of ``kernel_size``
    and ``padding`` over [h, x] ([r h, x] for q)."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel_size=3,
                 padding=1):
        super().__init__()

        def gate(activation):
            return ConvBlock(hidden_dim + input_dim, hidden_dim, kernel_size,
                             padding=padding, bias=True, normalization=None,
                             activation=activation)
        self.conv_z = gate(lambda_sigmoid())
        self.conv_r = gate(lambda_sigmoid())
        self.conv_q = gate(lambda_tanh())

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = self.conv_z(hx)
        r = self.conv_r(hx)
        q = self.conv_q(torch.cat([r * h, x], dim=1))
        return (1.0 - z) * h + z * q


class SepConvGRU(nn.Module):
    """A (1, 5) GRU pass, then a (5, 1) one (JAX ``raft.py:279``)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.horizontal_gru = ConvGRU(hidden_dim, input_dim, (1, 5), (0, 2))
        self.vertical_gru = ConvGRU(hidden_dim, input_dim, (5, 1), (2, 0))

    def forward(self, h, x):
        return self.vertical_gru(self.horizontal_gru(h, x), x)


class FlowHead(nn.Module):
    """A 3x3 conv block and a plain 3x3 conv to the flow's 2 channels (JAX
    ``raft.py:294``)."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 out_channels: int = 2):
        super().__init__()
        self.conv1 = conv3x3_block(in_channels, mid_channels, bias=True,
                                   normalization=None)
        self.conv2 = nn.Conv2d(mid_channels, out_channels, 3, padding=1,
                               bias=True)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class MaskHead(nn.Module):
    """A 3x3 conv block and a plain 1x1 conv to the upsampling mask (JAX
    ``raft.py:308``)."""

    def __init__(self, in_channels: int, mid_channels: int = 256,
                 out_channels: int = 576):
        super().__init__()
        self.conv1 = conv3x3_block(in_channels, mid_channels, bias=True,
                                   normalization=None)
        self.conv2 = conv1x1(mid_channels, out_channels, bias=True)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class RAFTUpdateBlock(nn.Module):
    """One refinement step (JAX ``raft.py:322``): motion features, the GRU
    over [context, motion], the flow delta and, where ``mask_out_channels``
    is not 0, the upsampling mask times 0.25. Returns (net, mask or None,
    delta)."""

    def __init__(self, hidden_dim: int, context_dim: int,
                 corr_channels: int, corr_out_channels_list: Sequence[int],
                 flow_out_channels_list: Sequence[int],
                 mout_out_channels: int = 126, sep_gru: bool = True,
                 flow_mid_channels: int = 256,
                 mask_out_channels: int = 576):
        super().__init__()
        self.encoder = RAFTMotionEncoder(
            corr_channels, corr_out_channels_list, flow_out_channels_list,
            mout_out_channels)
        gru = SepConvGRU if sep_gru else ConvGRU
        self.gru = gru(hidden_dim, context_dim + mout_out_channels + 2)
        self.flow_head = FlowHead(hidden_dim, flow_mid_channels)
        self.mask = MaskHead(hidden_dim, flow_mid_channels,
                             mask_out_channels) \
            if mask_out_channels != 0 else None

    def forward(self, net, inp, corr, flow):
        inp = torch.cat([inp, self.encoder(corr, flow)], dim=1)
        net = self.gru(net, inp)
        delta_flow = self.flow_head(net)
        # 0.25 balances the mask's gradients against the flow head's
        # (reference raft.py:707)
        mask = None if self.mask is None else 0.25 * self.mask(net)
        return net, mask, delta_flow


class RAFT(nn.Module):
    """RAFT (JAX ``raft.py:357``) from 'RAFT: Recurrent All-Pairs Field
    Transforms for Optical Flow', https://arxiv.org/abs/2003.12039.

    ``forward(image1, image2, flow_init=None)``: two (B, 3, H, W) frames,
    0..255 RGB when ``in_normalize`` (else already in [-1, 1]), H and W
    multiples of 8; ``flow_init`` (B, 2, H/8, W/8) starts the refinement.
    Both frames go through the feature net as one doubled batch, the first
    through the context net; ``iters`` refinements of the coordinates, then
    the last mask upsamples (bilinear where the update block has no mask
    head: ``raft_small``). Returns (flow at 1/8, flow at full size), both
    (B, 2, ., .) with channels (x, y)."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 hidden_dim: int = 128, context_dim: int = 128,
                 encoder_init_block_channels: int = 64,
                 encoder_mid_channels: Sequence[Sequence[int]] = (),
                 fnet_final_block_channels: int = 256,
                 encoder_bottleneck: bool = False,
                 cnet_normalize: bool = True,
                 corr_out_channels_list: Sequence[int] = (),
                 flow_out_channels_list: Sequence[int] = (),
                 mout_out_channels: int = 126, sep_gru: bool = True,
                 flow_mid_channels: int = 256,
                 mask_out_channels: int = 576, in_normalize: bool = True,
                 dropout_rate: float = 0.0, iters: int = 12,
                 in_channels: int = 3,
                 in_size: Tuple[int, int] = (240, 432)):
        super().__init__()
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.in_normalize = in_normalize
        self.iters = iters
        self.in_channels = in_channels
        self.in_size = tuple(in_size)
        encoder = dict(in_channels=in_channels,
                       init_block_channels=encoder_init_block_channels,
                       mid_channels=encoder_mid_channels,
                       bottleneck=encoder_bottleneck,
                       dropout_rate=dropout_rate)
        self.fnet = RAFTEncoder(
            final_block_channels=fnet_final_block_channels,
            normalization=lambda_instancenorm2d(), **encoder)
        self.cnet = RAFTEncoder(
            final_block_channels=hidden_dim + context_dim,
            normalization=True if cnet_normalize else None, **encoder)
        self.update_block = RAFTUpdateBlock(
            hidden_dim, context_dim, corr_levels * (2 * corr_radius + 1) ** 2,
            corr_out_channels_list, flow_out_channels_list,
            mout_out_channels, sep_gru, flow_mid_channels, mask_out_channels)

    def forward(self, image1, image2,
                flow_init: Optional[torch.Tensor] = None):
        assert image1.dim() == 4 and image1.shape == image2.shape
        if self.in_normalize:
            image1 = 2.0 * (image1 / 255.0) - 1.0
            image2 = 2.0 * (image2 / 255.0) - 1.0
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).chunk(2)
        pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels)
        ctx = self.cnet(image1)
        net = torch.tanh(ctx[:, :self.hidden_dim])
        inp = torch.relu(ctx[:, self.hidden_dim:])

        b, _, h, w = image1.shape
        coords0 = create_coords_grid(b, h // 8, w // 8, image1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        up_mask = None
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = lookup_corr(pyramid, coords1, self.corr_radius)
            net, up_mask, delta_flow = self.update_block(
                net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta_flow
        flow8 = coords1 - coords0
        if up_mask is None:
            return flow8, upsample_flow_using_interpolation(flow8)
        return flow8, upsample_flow_using_mask(flow8, up_mask)


def get_raft(version: str, **kwargs) -> RAFT:
    """The two configurations (JAX ``raft.py:454``): ``basic``
    (``raft_things``) and ``small`` (``raft_small``)."""
    if version == "basic":
        cfg = dict(
            corr_levels=4, corr_radius=4, hidden_dim=128, context_dim=128,
            encoder_init_block_channels=64,
            encoder_mid_channels=((64, 64), (96, 96), (128, 128)),
            fnet_final_block_channels=256, encoder_bottleneck=False,
            cnet_normalize=True, corr_out_channels_list=(256, 192),
            flow_out_channels_list=(128, 64), mout_out_channels=128 - 2,
            sep_gru=True, flow_mid_channels=256, mask_out_channels=64 * 9)
    elif version == "small":
        cfg = dict(
            corr_levels=4, corr_radius=3, hidden_dim=96, context_dim=64,
            encoder_init_block_channels=32,
            encoder_mid_channels=((32, 32), (64, 64), (96, 96)),
            fnet_final_block_channels=128, encoder_bottleneck=True,
            cnet_normalize=False, corr_out_channels_list=(96,),
            flow_out_channels_list=(64, 32), mout_out_channels=80,
            sep_gru=False, flow_mid_channels=128, mask_out_channels=0)
    else:
        raise ValueError(f"Unsupported RAFT version {version}")
    cfg.update(kwargs)
    return RAFT(**cfg)


@register_model("raft_things")
def raft_things(**kwargs) -> RAFT:
    return get_raft(version="basic", **kwargs)


@register_model("raft_small")
def raft_small(**kwargs) -> RAFT:
    return get_raft(version="small", **kwargs)


def calc_bidirectional_optical_flow_on_video_by_raft(apply_fn, frames):
    """Forward flows of (t, t+1), then backward flows of (t+1, t), between
    consecutive frames (JAX ``raft.py:490``): ``frames`` (T, 3, H, W), T >
    1; returns (T-1, 4, H, W) with channels (fwd_x, fwd_y, bwd_x,
    bwd_y)."""
    assert frames.dim() == 4 and frames.shape[0] > 1
    frames1 = frames[:-1]
    frames2 = frames[1:]
    _, flows_forward = apply_fn(frames1, frames2)
    _, flows_backward = apply_fn(frames2, frames1)
    return torch.cat([flows_forward, flows_backward], dim=1)
