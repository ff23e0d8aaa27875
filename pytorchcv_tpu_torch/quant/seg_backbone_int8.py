"""int8 serving pipeline of the dilated ResNet(D) segmentation backbone
(counterpart of ``pytorchcv_tpu.quant.seg_backbone_int8``'s
``prepare_int8_seg_backbone``).

The backbone is ``models.pspnet.segmentation_backbone``: children "0" (the
SENet deep stem) and "1".."4" (stages of bottleneck units, stride and
dilation at the 3x3, stride 2 only at stage 2 unit 1, stages 3 and 4
dilated). As in ``resnet_int8``, weights are quantized and BN folded once,
activations are int8 NHWC between convs, and every scalar is derived once
with the JAX pipeline's float32 roundings, so both outputs match it bit
for bit on the same weights and scales:

* stem: planar bf16 image -> folded bf16 3x3/s2 conv1, bias, ReLU, quant
  (kernel K3, no pool); int8 conv2 and conv3 (K2); int8 max-pool
  (``maxpool_i8``);
* every unit conv on K2; with ``bend`` the last unit of stage 3 also
  writes the bf16 "bend" in the same launch as its int8 output.

``fn(plan, x) -> (stage4, bend)``, both bf16 NHWC (the bend None when the
plan was built without it). The plain-trunk (pose, detection) half of the
JAX module is not yet ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.stem import maxpool_i8, stem_conv
from ..nn.conv import ConvBlock
from .resnet_int8 import (UnsupportedTreeError, _cell_consts, _conv_step,
                          _f32, _folded_stem_kernel, _planar_bf16, _run_step,
                          _unit, _unit_plan)

__all__ = ["is_seg_resnetd_backbone", "prepare_int8_seg_backbone"]

_STAGES = ("1", "2", "3", "4")
_BEND_STAGE = 3              # the stage whose output the head also takes


def is_seg_resnetd_backbone(model: nn.Module) -> bool:
    """True for a model whose ``backbone`` is the positional ResNet(D)-b
    deep-stem tree this pipeline walks: children "0".."4", a 3-conv stem,
    bottleneck units of conv + BN cells, no SE gate."""
    bb = getattr(model, "backbone", None)
    if not isinstance(bb, nn.Module) or \
            [n for n, _ in bb.named_children()] != ["0", *_STAGES]:
        return False
    if not all(isinstance(getattr(bb[0], f"conv{i}", None), ConvBlock)
               for i in (1, 2, 3)):
        return False
    for sk in _STAGES:
        stage = getattr(bb, sk)
        names = [n for n, _ in stage.named_children()]
        if not names or names[0] != "unit1":
            return False
        for unit in stage.children():
            body = getattr(unit, "body", None)
            if body is None or not hasattr(body, "conv3") or \
                    set(n for n, _ in unit.named_children()) - {
                        "body", "identity_conv", "activ"}:
                return False
            if not all(isinstance(blk, ConvBlock) and blk.bn is not None
                       for blk in body.children()):
                return False
    return True


def _unit_geometry_dilated(si: int, uj: int) -> Tuple[int, int]:
    """(stride, dilation) of the 3x3 in stage ``si``, unit ``uj`` (both
    1-based; reference resnetd.py:47-48)."""
    stride = 2 if (si == 2 and uj == 1) else 1
    dilation = 2 ** max(0, (si - 1) - 1 - int(uj == 1))
    return stride, dilation


def _forward(plan: Dict, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x``: planar (B, 3, H, W) or NHWC (B, H, W, 3) model input ->
    (stage4, bend), bf16 NHWC."""
    st = plan["stem"]
    xq = stem_conv(_planar_bf16(x), st["kf"], st["bias"], st["q"])
    for step in plan["stem_convs"]:
        xq = _run_step(step, xq)
    xq = maxpool_i8(xq)
    out = bend = None
    for u in plan["units"]:
        y = _unit(u, xq, bend=u["bend"])
        if u["bend"]:
            y, bend = y
        if y.dtype == torch.int8:
            xq = y
        else:
            out = y
    return out, bend


def prepare_int8_seg_backbone(model: nn.Module, scales: Dict[str, float],
                              bend: bool = True) -> Tuple[Callable, Dict]:
    """Quantize the dilated segmentation backbone of ``model`` once; return
    ``(fn, plan)`` with ``fn(plan, x) -> (stage4, stage3_bend)``, both bf16
    NHWC; without ``bend`` (a head that reads stage 4 only) the bend is
    None and never written. ``scales``: {path: amax} from
    ``calibrate_int8`` (or the JAX package's: the keys are the same). A 3x3
    whose stride or dilation differs from ``_unit_geometry_dilated``
    raises."""
    if not is_seg_resnetd_backbone(model):
        raise UnsupportedTreeError(
            "not a positional ResNet(D)-b deep-stem backbone")
    sc = scales.__getitem__
    bb = model.backbone
    with torch.no_grad():
        stem = bb[0]
        s_c2 = sc("backbone/0/conv2/conv")
        s_c3 = sc("backbone/0/conv3/conv")
        s_u1 = sc("backbone/1/unit1/body/conv1/conv")
        plan = {"stem": {"kf": _folded_stem_kernel(stem.conv1),
                         "bias": _cell_consts(stem.conv1,
                                              "backbone/0/conv1")["bias"],
                         "q": _f32(127.0 / s_c2)},
                "stem_convs": [
                    _conv_step(_cell_consts(stem.conv2, "backbone/0/conv2"),
                               s_c2, True, s_c3),
                    _conv_step(_cell_consts(stem.conv3, "backbone/0/conv3"),
                               s_c3, True, s_u1)],
                "units": []}
        s_in = s_u1
        for si in range(1, 5):
            units = list(getattr(bb, str(si)).named_children())
            for uj, (uname, unit) in enumerate(units, start=1):
                prefix = f"backbone/{si}/{uname}"
                conv2 = unit.body.conv2.conv
                geometry = _unit_geometry_dilated(si, uj)
                if (conv2.stride[0], conv2.dilation[0]) != geometry:
                    raise UnsupportedTreeError(
                        f"{prefix}: 3x3 stride/dilation "
                        f"{(conv2.stride[0], conv2.dilation[0])} differs "
                        f"from the dilated geometry {geometry}")
                if uj < len(units):
                    nxt = f"backbone/{si}/{units[uj][0]}/body/conv1/conv"
                elif si < 4:
                    nxt = f"backbone/{si + 1}/unit1/body/conv1/conv"
                else:
                    nxt = None
                s_next = sc(nxt) if nxt else None
                uq = {"body": {name: _cell_consts(blk, f"{prefix}/body/{name}")
                               for name, blk in unit.body.named_children()}}
                if unit.identity_conv is not None:
                    uq["identity_conv"] = _cell_consts(
                        unit.identity_conv, f"{prefix}/identity_conv")
                u = _unit_plan(uq, f"{prefix}/body", s_in, s_next, sc)
                u["bend"] = bend and si == _BEND_STAGE and uj == len(units)
                plan["units"].append(u)
                if s_next is not None:
                    s_in = s_next
    return _forward, plan
