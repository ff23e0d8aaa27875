"""ProPainter's video inpainting generator, NCHW. Counterpart of
``pytorchcv_tpu.models.propainter`` (reference pytorchcv
``models/propainter.py``), from 'ProPainter: Improving Propagation and
Transformer for Video Inpainting', https://arxiv.org/abs/2309.03897.

Video tensors are (B, T, C, H, W) and flows (B, T-1, 4, H, W); the
transformer's tokens are channels-last (B, T, h, w, C), as its linear
layers take them. The encoder's features of the local frames propagate
along the flows (``BidirectionalPropagation``, deformable alignment on K5),
soft split turns every frame into tokens (unfold, then a linear layer),
eight temporal sparse transformer blocks mix them, soft composite folds
them back, and the decoder paints the local frames.

The sparse window attention computes both of the reference's paths for
every window, as the JAX model does: the full path (a window's tokens of
all frames against the window's, the rolled and the pooled tokens of the
sampled frames) and the window-local one; each window's mask selects one.
Both run on K7 (``kernels/attention.py``), or on its plain version when
autograd records the forward (K7 has no backward). Soft split and soft
composite keep the reference's unfold / linear / fold formulation, whose
weights are the JAX layers' (``(C*kh*kw)`` rows or columns in unfold's
channel-major ``(c, ki, kj)`` order).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._build import autograd_records
from ..kernels.attention import (fused_window_attention,
                                 fused_window_attention_reference)
from ..nn import (InterpolationBlock, Sequential, conv3x3_block, interpolate,
                  lambda_leakyrelu, lambda_tanh)
from ..nn.activ import Activation
from .propainter_ip import BidirectionalPropagation
from .registry import register_model

__all__ = ["ProPainter", "get_propainter", "Encoder", "Decoder",
           "SoftSplit", "SoftComp", "SparseWindowAttention",
           "FusionFeedForward", "TemporalSparseTransformer",
           "TemporalSparseTransformerBlock", "window_partition"]

Pair = Tuple[int, int]


def _grid_size(size: Pair, kernel_size: Pair, stride: Pair,
               padding: Pair) -> Pair:
    """Patches of unfold per axis."""
    return tuple((size[i] + 2 * padding[i] - kernel_size[i]) // stride[i] + 1
                 for i in range(2))


class Encoder(nn.Module):
    """Nine 3x3 conv blocks; blocks 5-8 take the output of block 3
    interleaved group by group with the previous block's (JAX
    ``propainter.py:84``)."""

    _CFG = ((64, 2, 1), (64, 1, 1), (128, 2, 1), (256, 1, 1), (384, 1, 1),
            (512, 1, 2), (384, 1, 4), (256, 1, 8), (128, 1, 1))
    _GROUPS = (1, 2, 4, 8, 1)

    def __init__(self, in_channels: int = 5,
                 activation: Activation = lambda_leakyrelu(0.2)):
        super().__init__()
        layers, prev = [], in_channels
        for i, (oc, stride, groups) in enumerate(self._CFG):
            cin = prev + (self._CFG[3][0] if i > 4 else 0)
            layers.append((str(i), conv3x3_block(
                cin, oc, stride=stride, groups=groups, bias=True,
                normalization=False, activation=activation)))
            prev = oc
        self.layers = Sequential(layers)

    def forward(self, x):
        out, x0 = x, None
        for i, layer in enumerate(self.layers):
            if i == 4:
                x0 = out
            if i > 4:
                g = self._GROUPS[i - 4]
                b, _, h, w = out.shape
                out = torch.cat([x0.view(b, g, -1, h, w),
                                 out.view(b, g, -1, h, w)], dim=2).view(
                                     b, -1, h, w)
            out = layer(out)
        return out


class PPDecoderUnit(nn.Module):
    """x2 bilinear upsampling, then two 3x3 conv blocks (JAX
    ``propainter.py:115``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: Activation, final_activation: Activation):
        super().__init__()
        self.up = InterpolationBlock(scale_factor=2)
        self.conv1 = conv3x3_block(in_channels, in_channels, bias=True,
                                   normalization=False, activation=activation)
        self.conv2 = conv3x3_block(in_channels, out_channels, bias=True,
                                   normalization=False,
                                   activation=final_activation)

    def forward(self, x):
        return self.conv2(self.conv1(self.up(x)))


class Decoder(nn.Module):
    """Two decoder units, the last ending in tanh (JAX
    ``propainter.py:137``)."""

    def __init__(self, in_channels: int = 128, mid_channels: int = 64,
                 out_channels: int = 3,
                 activation: Activation = lambda_leakyrelu(0.2)):
        super().__init__()
        self.unit1 = PPDecoderUnit(in_channels, mid_channels, activation,
                                   activation)
        self.unit2 = PPDecoderUnit(mid_channels, out_channels, activation,
                                   lambda_tanh())

    def forward(self, x):
        return self.unit2(self.unit1(x))


class SoftSplit(nn.Module):
    """Unfold, then a linear token embedding (JAX ``propainter.py:185``):
    (B*T, C, H, W) -> (B, T, h, w, hidden)."""

    def __init__(self, in_channels: int = 128, hidden_dim: int = 512,
                 kernel_size: Pair = (7, 7), stride: Pair = (3, 3),
                 padding: Pair = (3, 3)):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.embedding = nn.Linear(
            in_channels * kernel_size[0] * kernel_size[1], hidden_dim)

    def forward(self, x, batch: int):
        fh, fw = _grid_size(x.shape[2:], self.kernel_size, self.stride,
                            self.padding)
        x = F.unfold(x, self.kernel_size, padding=self.padding,
                     stride=self.stride)
        x = self.embedding(x.transpose(1, 2))
        return x.view(batch, -1, fh, fw, x.shape[-1])


class SoftComp(nn.Module):
    """A linear token de-embedding, fold (overlapping patches add up), then
    a 3x3 conv (JAX ``propainter.py:284``): (B, T, h, w, hidden) ->
    (B*T, C, H, W)."""

    def __init__(self, channels: int = 128, hidden_dim: int = 512,
                 kernel_size: Pair = (7, 7), stride: Pair = (3, 3),
                 padding: Pair = (3, 3)):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.embedding = nn.Linear(
            hidden_dim, channels * kernel_size[0] * kernel_size[1])
        self.bias_conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, output_size: Pair):
        b, t, fh, fw, hid = x.shape
        y = self.embedding(x.reshape(b * t, fh * fw, hid))
        y = F.fold(y.transpose(1, 2), tuple(output_size), self.kernel_size,
                   padding=self.padding, stride=self.stride)
        return self.bias_conv(y)


def window_partition(x, window_size: Pair, num_heads: int):
    """(B, T, H, W, C) -> (B, nWh*nWw, heads, T, wh*ww, C/heads) (JAX
    ``propainter.py:309``)."""
    b, t, h, w, c = x.shape
    wh, ww = window_size
    x = x.view(b, t, h // wh, wh, w // ww, ww, num_heads, c // num_heads)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (h // wh) * (w // ww), num_heads, t, wh * ww,
                     c // num_heads)


@functools.lru_cache(maxsize=None)
def _rolled_valid_index(window_size: Pair) -> np.ndarray:
    """Indices of the tokens kept from the four rolled windows' 4*wh*ww:
    of each rolled copy, the tokens that the window itself lacks."""
    wh, ww = window_size
    e0, e1 = (wh + 1) // 2, (ww + 1) // 2
    masks = []
    for fill in ((slice(None, -e0), slice(None, -e1)),
                 (slice(None, -e0), slice(e1, None)),
                 (slice(e0, None), slice(None, -e1)),
                 (slice(e0, None), slice(e1, None))):
        m = np.ones((wh, ww), np.float32)
        m[fill] = 0
        masks.append(m)
    return np.nonzero(np.stack(masks, 0).reshape(-1))[0]


class SparseWindowAttention(nn.Module):
    """Sparse window attention, both paths for every window (JAX
    ``propainter.py:321``): ``forward(x (B, T, h, w, C), mask (B, l_t, h,
    w, 1), time_idx)`` -> (B, T, h, w, C). ``time_idx``, a LongTensor, picks
    the frames whose keys and values the full path reads."""

    def __init__(self, dim: int = 512, num_heads: int = 4,
                 window_size: Pair = (5, 9), pool_size: Pair = (4, 4)):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.pool_layer = nn.Conv2d(dim, dim, pool_size, stride=pool_size,
                                    groups=dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask, time_idx: Optional[torch.Tensor] = None):
        b, t, h, w, c = x.shape
        wh, ww = self.window_size
        heads = self.num_heads
        c_head = c // heads
        n_wh, n_ww = math.ceil(h / wh), math.ceil(w / ww)
        new_h, new_w = n_wh * wh, n_ww * ww
        pad_r, pad_b = new_w - w, new_h - h
        if pad_r > 0 or pad_b > 0:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            mask = F.pad(mask, (0, 0, 0, pad_r, 0, pad_b))
        q, k, v = self.query(x), self.key(x), self.value(x)
        nw = n_wh * n_ww

        def part(a):
            return window_partition(a, self.window_size, heads)

        win_q, win_k, win_v = part(q), part(k), part(v)
        ks, vs = [win_k], [win_v]
        e0, e1 = (wh + 1) // 2, (ww + 1) // 2
        valid = torch.as_tensor(_rolled_valid_index(self.window_size),
                                device=x.device)
        shifts = ((-e0, -e1), (-e0, e1), (e0, -e1), (e0, e1))
        for src, dst in ((k, ks), (v, vs)):
            rolled = torch.cat([part(torch.roll(src, s, dims=(2, 3)))
                                for s in shifts], dim=4)
            dst.append(rolled[:, :, :, :, valid])
        px = self.pool_layer(x.reshape(b * t, new_h, new_w, c).permute(
            0, 3, 1, 2))
        ph, pw = px.shape[2:]
        px = px.permute(0, 2, 3, 1).reshape(b, t, ph * pw, c)

        def to_win(a):
            a = a.view(b, t, ph * pw, heads, c_head).permute(0, 3, 1, 2, 4)
            return a[:, None].expand(b, nw, heads, t, ph * pw, c_head)

        ks.append(to_win(self.key(px)))
        vs.append(to_win(self.value(px)))
        win_k_all = torch.cat(ks, dim=4)
        win_v_all = torch.cat(vs, dim=4)

        # a window is masked when any local frame has a masked pixel in it
        l_t = mask.shape[1]
        mpool = F.max_pool2d(mask.reshape(b * l_t, new_h, new_w, 1).permute(
            0, 3, 1, 2), self.window_size)
        win_masked = mpool.reshape(b, l_t, nw).sum(dim=1) > 0

        scale = 1.0 / math.sqrt(c_head)
        if time_idx is not None:
            win_k_all = win_k_all[:, :, :, time_idx]
            win_v_all = win_v_all[:, :, :, time_idx]
        k_full = win_k_all.reshape(b, nw, heads, -1, c_head)
        v_full = win_v_all.reshape(b, nw, heads, -1, c_head)
        q_full = win_q.reshape(b, nw, heads, t * wh * ww, c_head)
        attend = fused_window_attention_reference \
            if autograd_records(q_full, k_full, v_full) \
            else fused_window_attention
        y_full = attend(q_full, k_full, v_full, scale).view(
            b, nw, heads, t, wh * ww, c_head)
        y_local = attend(win_q, win_k, win_v, scale)
        out = torch.where(win_masked[:, :, None, None, None, None], y_full,
                          y_local)
        out = out.view(b, n_wh, n_ww, heads, t, wh, ww, c_head).permute(
            0, 4, 1, 5, 2, 6, 3, 7).reshape(b, t, new_h, new_w, c)
        if pad_r > 0 or pad_b > 0:
            out = out[:, :, :h, :w]
        return self.proj(out)


@functools.lru_cache(maxsize=None)
def _fold_counts_np(output_size: Pair, kernel_size: Pair, stride: Pair,
                    padding: Pair) -> np.ndarray:
    """Patches of fold covering each pixel (``fold(ones)``), from the
    geometry alone (JAX ``propainter.py:445``)."""
    kh, kw = kernel_size
    sh, sw = stride
    ph, pw = padding
    h, w = output_size
    fh, fw = _grid_size(output_size, kernel_size, stride, padding)
    canvas = np.zeros((h + 2 * ph, w + 2 * pw), np.float32)
    for qy in range(fh):
        for qx in range(fw):
            canvas[qy * sh:qy * sh + kh, qx * sw:qx * sw + kw] += 1.0
    return canvas[ph:ph + h, pw:pw + w]


class FusionFeedForward(nn.Module):
    """Linear, fold / normalize / unfold (neighbouring tokens mix), GELU,
    linear (JAX ``propainter.py:461``): (B, N, dim) -> (B, N, dim)."""

    def __init__(self, dim: int = 512, hidden_dim: int = 1960,
                 kernel_size: Pair = (7, 7), stride: Pair = (3, 3),
                 padding: Pair = (3, 3)):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.fc1 = nn.Sequential(nn.Linear(dim, hidden_dim))
        self.fc2 = nn.Sequential(nn.GELU(), nn.Linear(hidden_dim, dim))

    def forward(self, x, output_size: Pair):
        output_size = tuple(output_size)
        fh, fw = _grid_size(output_size, self.kernel_size, self.stride,
                            self.padding)
        x = self.fc1(x)
        b, n, c = x.shape
        geometry = (output_size, self.kernel_size, self.stride, self.padding)
        inv_norm = torch.from_numpy(1.0 / _fold_counts_np(*geometry)).to(x)
        folded = F.fold(x.view(-1, fh * fw, c).transpose(1, 2), output_size,
                        self.kernel_size, padding=self.padding,
                        stride=self.stride)
        y = F.unfold(folded * inv_norm, self.kernel_size,
                     padding=self.padding, stride=self.stride)
        return self.fc2(y.transpose(1, 2).reshape(b, n, c))


class TemporalSparseTransformer(nn.Module):
    """Pre-norm sparse window attention and fusion feed-forward, each with
    its residual (JAX ``propainter.py:502``)."""

    def __init__(self, dim: int = 512, num_heads: int = 4,
                 window_size: Pair = (5, 9), pool_size: Pair = (4, 4),
                 kernel_size: Pair = (7, 7), stride: Pair = (3, 3),
                 padding: Pair = (3, 3)):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attention = SparseWindowAttention(dim, num_heads, window_size,
                                               pool_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = FusionFeedForward(dim, 1960, kernel_size, stride, padding)

    def forward(self, x, fold_x_size: Pair, mask, time_idx=None):
        b, t, h, w, c = x.shape
        x = x + self.attention(self.norm1(x), mask, time_idx)
        y = self.mlp(self.norm2(x).view(b, t * h * w, c), fold_x_size)
        return x + y.view(b, t, h, w, c)


class TemporalSparseTransformerBlock(nn.Module):
    """``depth`` transformers; transformer i reads the keys and values of
    frames i, i + d, i + 2d, ... (mod the dilation d) on its full path (JAX
    ``propainter.py:532``)."""

    def __init__(self, dim: int = 512, num_heads: int = 4,
                 window_size: Pair = (5, 9), pool_size: Pair = (4, 4),
                 kernel_size: Pair = (7, 7), stride: Pair = (3, 3),
                 padding: Pair = (3, 3), depth: int = 8):
        super().__init__()
        self.transformer = nn.Sequential(*[
            TemporalSparseTransformer(dim, num_heads, window_size, pool_size,
                                      kernel_size, stride, padding)
            for _ in range(depth)])

    def forward(self, x, fold_x_size: Pair, l_mask, time_dilation: int = 2):
        if len(self.transformer) % time_dilation:
            raise ValueError(f"depth {len(self.transformer)} is not a "
                             f"multiple of the dilation {time_dilation}")
        t = x.shape[1]
        time_idx = [torch.arange(i, t, time_dilation, device=x.device)
                    for i in range(time_dilation)]
        for i, block in enumerate(self.transformer):
            x = block(x, fold_x_size, l_mask, time_idx[i % time_dilation])
        return x


class ProPainter(nn.Module):
    """ProPainter generator (JAX ``propainter.py:566``).

    ``forward(masked_frames (B, T, 3, H, W), masks_updated (B, T, 1, H, W),
    masks_in (B, T, 1, H, W), completed_flows (B, l_t - 1, 4, H, W),
    num_local_frames=l_t)`` -> the inpainted local frames (B, l_t, 3, H,
    W); the first l_t frames are local, the others references. H and W are
    multiples of 4. Eval only: the mask pool reads the local frames."""

    def __init__(self, channels: int = 128, hidden_dim: int = 512,
                 num_heads: int = 4, depth: int = 8,
                 t2t_kernel_size: Pair = (7, 7), t2t_padding: Pair = (3, 3),
                 t2t_stride: Pair = (3, 3), window_size: Pair = (5, 9),
                 pool_size: Pair = (4, 4), in_size: Pair = (240, 432)):
        super().__init__()
        self.in_size = tuple(in_size)
        self.t2t = (tuple(t2t_kernel_size), tuple(t2t_stride),
                    tuple(t2t_padding))
        act = lambda_leakyrelu(0.2)
        self.encoder = Encoder(5, act)
        self.decoder = Decoder(channels, 64, 3, act)
        self.ss = SoftSplit(channels, hidden_dim, *self.t2t)
        self.sc = SoftComp(channels, hidden_dim, *self.t2t)
        self.feat_prop_module = BidirectionalPropagation(channels,
                                                         learnable=True)
        self.transformers = TemporalSparseTransformerBlock(
            hidden_dim, num_heads, window_size, pool_size, *self.t2t,
            depth=depth)

    def forward(self, masked_frames, masks_updated, masks_in,
                completed_flows, num_local_frames: int = 4,
                interpolation: str = "bilinear", time_dilation: int = 2):
        l_t = num_local_frames
        b, t, _, oh, ow = masked_frames.shape
        if oh % 4 or ow % 4 or tuple(completed_flows.shape[1:3]) != \
                (l_t - 1, 4):
            raise ValueError(
                f"ProPainter: frames (B, T, 3, H, W) with H, W multiples of "
                f"4 and flows (B, {l_t - 1}, 4, H, W), got "
                f"{tuple(masked_frames.shape)}, "
                f"{tuple(completed_flows.shape)}")
        enc_in = torch.cat([masked_frames, masks_in, masks_updated], dim=2)
        enc_feat = self.encoder(enc_in.view(b * t, -1, oh, ow))
        _, c, h, w = enc_feat.shape
        enc_feat = enc_feat.view(b, t, c, h, w)

        def ds_flow(f):
            f = interpolate(f.reshape(-1, 2, oh, ow), (oh // 4, ow // 4),
                            mode="bilinear", align_corners=False)
            return f.view(b, l_t - 1, 2, h, w) / 4.0

        def ds_mask(m):
            m = interpolate(m.reshape(-1, 1, oh, ow), (oh // 4, ow // 4),
                            mode="nearest")
            return m.view(b, -1, 1, h, w)

        ds_mask_in_local = ds_mask(masks_in)[:, :l_t]
        ds_mask_updated_local = ds_mask(masks_updated[:, :l_t])
        # the window mask of the attention: the local frames' masks pooled
        # as soft split cuts them into patches
        kernel, stride, padding = self.t2t
        mask_pool_l = F.max_pool2d(ds_mask_in_local.reshape(-1, 1, h, w),
                                   kernel, stride, padding)
        mask_pool_l = mask_pool_l.view(b, l_t, *mask_pool_l.shape[2:], 1)

        _, _, local_feat, _ = self.feat_prop_module(
            enc_feat[:, :l_t], ds_flow(completed_flows[:, :, :2]),
            ds_flow(completed_flows[:, :, 2:]),
            torch.cat([ds_mask_in_local, ds_mask_updated_local], dim=2),
            interpolation=interpolation)
        enc_feat = torch.cat([local_feat, enc_feat[:, l_t:]], dim=1)

        trans_feat = self.ss(enc_feat.view(b * t, c, h, w), b)
        trans_feat = self.transformers(trans_feat, (h, w), mask_pool_l,
                                       time_dilation)
        trans_feat = self.sc(trans_feat, (h, w))
        enc_feat = enc_feat + trans_feat.view(b, t, c, h, w)
        output = self.decoder(enc_feat[:, :l_t].reshape(-1, c, h, w))
        return output.view(b, l_t, 3, oh, ow)


def get_propainter(**kwargs) -> ProPainter:
    return ProPainter(**kwargs)


@register_model("propainter")
def propainter(**kwargs):
    return get_propainter(**kwargs)
