"""ProPainter image propagation (IP), NCHW. Counterpart of
``pytorchcv_tpu.models.propainter_ip`` (reference pytorchcv
``models/propainter_ip.py``), from 'ProPainter: Improving Propagation and
Transformer for Video Inpainting', https://arxiv.org/abs/2309.03897.

Video tensors are (B, T, C, H, W); flows (B, T-1, 2, H, W) with (dx, dy)
channels. ``PPImagePropagation`` has no parameters: flow warping and
consistency-gated blending of pixels. The learnable
``BidirectionalPropagation`` (second-order deformable alignment on K5 and
fusing residual blocks) is the one inside the generator
(``models/propainter.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import grid_sample, lambda_leakyrelu
from .propainter_rfc import SecondOrderDeformableAlignment
from .registry import register_model
from .resnet import ResBlock

__all__ = ["PPImagePropagation", "BidirectionalPropagation", "flow_warp",
           "fb_consistency_check", "get_propainter_ip"]


def flow_warp(x, flow, interpolation: str = "bilinear",
              align_corners: bool = True):
    """Warp ``x`` (B, C, H, W) by the pixel offsets ``flow`` (B, 2, H, W) =
    (dx, dy), with f32 coordinates (JAX ``propainter_ip.py:31``)."""
    _, _, h, w = x.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    fx = gx + flow[:, 0].to(torch.float32)
    fy = gy + flow[:, 1].to(torch.float32)
    grid = torch.stack([2.0 * fx / max(w - 1, 1) - 1.0,
                        2.0 * fy / max(h - 1, 1) - 1.0], dim=-1)
    return grid_sample(x, grid, mode=interpolation,
                       align_corners=align_corners)


def length_sq(x):
    """Squared length over the channel axis, kept: (B, C, H, W) ->
    (B, 1, H, W)."""
    return torch.sum(torch.square(x), dim=1, keepdim=True)


def fb_consistency_check(flow_fw, flow_bw, alpha1: float = 0.01,
                         alpha2: float = 0.5):
    """Forward-backward consistency mask (B, 1, H, W) of flows (B, 2, H, W)
    (JAX ``propainter_ip.py:51``)."""
    flow_bw_warped = flow_warp(flow_bw, flow_fw)
    flow_diff_fw = flow_fw + flow_bw_warped
    mag_sq_fw = length_sq(flow_fw) + length_sq(flow_bw_warped)
    occ_thresh_fw = alpha1 * mag_sq_fw + alpha2
    return (length_sq(flow_diff_fw) < occ_thresh_fw).to(flow_fw.dtype)


def _binary_mask(mask, th: float = 0.1):
    return (mask > th).to(mask.dtype)


class BidirectionalPropagation(nn.Module):
    """Flow-guided bidirectional propagation (JAX ``propainter_ip.py:66``):
    ``forward(x (B, T, C, H, W), flows_forward, flows_backward
    (B, T-1, 2, H, W), mask (B, T, M, H, W))`` -> (outputs_b, outputs_f,
    outputs, masks_f), the last None when ``learnable``. The backward pass
    runs first.

    ``learnable``: frame i > 0 of a pass is the deformable alignment of the
    propagated features (offsets ``3 tanh(.)`` around the flow), then a
    residual block; a fusing residual block joins the two passes. Else the
    warped pixels replace the current frame's where the flows agree and the
    current frame is masked, and the mask shrinks accordingly."""

    _DIRS = ("backward_1", "forward_1")

    def __init__(self, channels: int = 3, learnable: bool = True,
                 mask_channels: int = 2):
        super().__init__()
        self.channels = channels
        self.learnable = learnable
        if learnable:
            c, m = channels, mask_channels
            act = lambda_leakyrelu(0.2)
            self.deform_align = nn.ModuleDict({
                d: SecondOrderDeformableAlignment(
                    c, 2 * c + 3 + m, c, deform_groups=16,
                    max_residue_magnitude=3)
                for d in self._DIRS})
            self.backbone = nn.ModuleDict({
                d: ResBlock(2 * c + m, c, 1, bias=True, normalization=False,
                            activation=act)
                for d in self._DIRS})
            self.fuse = ResBlock(2 * c + m, c, 1, bias=True,
                                 normalization=False, activation=act)

    def forward(self, x, flows_forward, flows_backward, mask,
                interpolation: str = "bilinear"):
        b, t, c, h, w = x.shape
        if c != self.channels:
            raise ValueError(f"BidirectionalPropagation: {c} channels, "
                             f"built for {self.channels}")
        feats = {"input": [x[:, i] for i in range(t)]}
        masks = {"input": [mask[:, i] for i in range(t)]}
        cache = ("input",) + self._DIRS
        for p_i, d in enumerate(self._DIRS):
            feats[d], masks[d] = [], []
            if d == "backward_1":
                frame_idx = list(range(t - 1, -1, -1))
                flow_idx = frame_idx
                flows_prop, flows_check = flows_forward, flows_backward
            else:
                frame_idx = list(range(t))
                flow_idx = list(range(-1, t - 1))
                flows_prop, flows_check = flows_backward, flows_forward
            for i, idx in enumerate(frame_idx):
                feat_current = feats[cache[p_i]][idx]
                mask_current = masks[cache[p_i]][idx]
                if i == 0:
                    feat_prop, mask_prop = feat_current, mask_current
                else:
                    flow_prop = flows_prop[:, flow_idx[i]]
                    flow_valid = fb_consistency_check(
                        flow_prop, flows_check[:, flow_idx[i]])
                    feat_warped = flow_warp(feat_prop, flow_prop,
                                            interpolation)
                    if self.learnable:
                        cond = torch.cat([feat_current, feat_warped,
                                          flow_prop, flow_valid,
                                          mask_current], dim=1)
                        feat_prop = self.deform_align[d](feat_prop, cond,
                                                         flow_prop)
                        mask_prop = mask_current
                    else:
                        prop_valid = _binary_mask(flow_warp(mask_prop,
                                                            flow_prop))
                        union_valid = _binary_mask(
                            mask_current * flow_valid * (1 - prop_valid))
                        feat_prop = union_valid * feat_warped + \
                            (1 - union_valid) * feat_current
                        mask_prop = _binary_mask(
                            mask_current * (1 - flow_valid * (1 - prop_valid)))
                if self.learnable:
                    feat = torch.cat([feat_current, feat_prop, mask_current],
                                     dim=1)
                    feat_prop = feat_prop + self.backbone[d](feat)
                feats[d].append(feat_prop)
                masks[d].append(mask_prop)
            if d == "backward_1":
                feats[d] = feats[d][::-1]
                masks[d] = masks[d][::-1]

        outputs_b = torch.stack(feats["backward_1"], dim=1)
        outputs_f = torch.stack(feats["forward_1"], dim=1)
        if self.learnable:
            fused_in = torch.cat([outputs_b, outputs_f, mask], dim=2)
            outputs = self.fuse(fused_in.view(b * t, -1, h, w)) + \
                x.reshape(b * t, c, h, w)
            return outputs_b, outputs_f, outputs.view(b, t, c, h, w), None
        return outputs_b, outputs_f, outputs_f, torch.stack(
            masks["forward_1"], dim=1)


class PPImagePropagation(nn.Module):
    """Parameterless image propagation (JAX ``propainter_ip.py:171``):
    ``forward(frames (T, 3, H, W), masks (T, 1, H, W), comp_flows
    (T-1, 4, H, W))`` -> (propagated frames (T, 3, H, W), updated masks
    (T, 1, H, W)). The flows are (forward, backward)."""

    def __init__(self, in_channels: int = 3, in_size=(240, 432)):
        super().__init__()
        self.in_size = tuple(in_size)
        self.prop = BidirectionalPropagation(in_channels, learnable=False)

    def forward(self, frames, masks, comp_flows,
                interpolation: str = "nearest"):
        if frames.dim() != 4 or comp_flows.shape[1] != 4:
            raise ValueError(f"PPImagePropagation: frames (T, 3, H, W) and "
                             f"flows (T-1, 4, H, W), got "
                             f"{tuple(frames.shape)}, "
                             f"{tuple(comp_flows.shape)}")
        masked_frames = frames * (1 - masks)
        _, _, prop_frames, updated_masks = self.prop(
            masked_frames[None], comp_flows[None, :, :2],
            comp_flows[None, :, 2:], masks[None],
            interpolation=interpolation)
        return prop_frames[0], updated_masks[0]


def get_propainter_ip(**kwargs) -> PPImagePropagation:
    return PPImagePropagation(**kwargs)


@register_model("propainter_ip")
def propainter_ip(**kwargs):
    return get_propainter_ip(**kwargs)
