"""Resampling, pooling, the hourglass's cut, pixel shuffle and the heatmap
keypoint decode (counterparts in ``pytorchcv_tpu.nn.ops``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .activ import Activation, create_activation
from .conv import conv3x3_block
from .norm import BN_EPS

__all__ = ["interpolate", "grid_sample", "BreakBlock", "InterpolationBlock",
           "global_avg_pool2d", "DucBlock", "HeatmapMaxDetBlock",
           "NormActivation"]


def interpolate(x, size: Tuple[int, int], mode: str = "bilinear",
                align_corners: bool = True):
    """NCHW resize to ``size``, torch semantics as the JAX package
    reproduces them (``nn/ops.py:141``); the identity at the input's own
    size. Bilinear with ``align_corners=True`` samples at
    ``i * (in-1)/(out-1)``, with ``False`` at half-pixel centers
    ``(i + 0.5) * in/out - 0.5`` (no antialias); nearest takes
    ``floor(i * in/out)``."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest")
    if mode != "bilinear":
        raise ValueError(f"interpolate: unsupported mode {mode!r}")
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners, antialias=False)


def grid_sample(x, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = False):
    """``F.grid_sample`` with f32 coordinates whatever x's type (JAX
    ``nn/ops.py:452``): ``x`` (B, C, H, W), ``grid`` (B, Hg, Wg, 2) of
    normalized (x, y). Nearest rounds half to even and zero padding tests
    the bounds after rounding, as the JAX function does; x of another type
    is sampled in f32 and rounded back."""
    out = F.grid_sample(x.to(torch.float32), grid.to(torch.float32),
                        mode=mode, padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(x.dtype)


class BreakBlock(nn.Module):
    """Returns None: cuts an hourglass skip (JAX ``nn/ops.py:41``)."""

    def forward(self, x):
        return None


class InterpolationBlock(nn.Module):
    """NCHW bilinear upsampling by ``scale_factor`` with
    ``align_corners=True`` (JAX ``nn/ops.py:168``)."""

    def __init__(self, scale_factor: int):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x):
        h, w = x.shape[2:]
        return interpolate(x, (h * self.scale_factor, w * self.scale_factor))


class _GlobalAvgPool2d(nn.Module):
    def __init__(self, keepdim: bool = False):
        super().__init__()
        self.keepdim = keepdim

    def forward(self, x):
        return x.mean((2, 3), keepdim=self.keepdim)


def global_avg_pool2d(keepdims: bool = False) -> nn.Module:
    """Mean over H and W: (B, C, H, W) -> (B, C), or (B, C, 1, 1) with
    ``keepdims`` (JAX ``nn/ops.py:355``)."""
    return _GlobalAvgPool2d(keepdims)


class DucBlock(nn.Module):
    """Dense upsampling convolution: a 3x3 conv block to ``scale_factor^2 *
    out_channels``, then the pixel shuffle (JAX ``nn/ops.py:245``; its
    ``pixel_shuffle`` at ``:234`` is ``F.pixel_shuffle`` on NCHW: channel
    ``c r^2 + i r + j`` goes to pixel (h r + i, w r + j) of channel c)."""

    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = conv3x3_block(in_channels,
                                  scale_factor ** 2 * out_channels)

    def forward(self, x):
        return F.pixel_shuffle(self.conv(x), self.scale_factor)


class HeatmapMaxDetBlock(nn.Module):
    """Keypoints of a heatmap (JAX ``nn/ops.py:260``): (B, K, H, W) ->
    (B, K, 3) of (x, y, score) in the heatmap's type. Each map's first
    maximum (the lowest flat index among equal maxima, as ``jnp.argmax``);
    a maximum not above 0 gives (0, 0); inside the border the position
    moves 0.25 px toward the larger of its two neighbours on each axis (by
    the sign of their difference: none on a tie)."""

    def forward(self, heatmap):
        b, k, h, w = heatmap.shape
        vec = heatmap.reshape(b, k, h * w)
        scores, indices = torch.max(vec, dim=2)
        mask = scores > 0.0
        zero = torch.zeros_like(indices)
        px = torch.where(mask, indices % w, zero)
        py = torch.where(mask, indices // w, zero)
        inner = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
        pxc = px.clamp(1, w - 2)
        pyc = py.clamp(1, h - 2)

        def gather(dy, dx):
            idx = (pyc + dy) * w + (pxc + dx)
            return torch.gather(vec, 2, idx[..., None])[..., 0]

        dx_sign = torch.sign(gather(0, 1) - gather(0, -1))
        dy_sign = torch.sign(gather(1, 0) - gather(-1, 0))
        none = torch.zeros_like(dx_sign)
        fx = px.to(heatmap.dtype) + torch.where(inner, dx_sign * 0.25, none)
        fy = py.to(heatmap.dtype) + torch.where(inner, dy_sign * 0.25, none)
        return torch.stack([fx, fy, scores], dim=2)


class NormActivation(nn.Module):
    """BatchNorm2d -> activation (ReLU by default): the final block of
    PreResNet (JAX ``nn/ops.py:102``), children ``bn`` and ``activ``."""

    def __init__(self, in_channels: int, activation: Activation = True):
        super().__init__()
        self.bn = nn.BatchNorm2d(in_channels, eps=BN_EPS)
        self.activ = create_activation(activation)

    def forward(self, x):
        x = self.bn(x)
        return x if self.activ is None else self.activ(x)
