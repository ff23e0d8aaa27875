"""int8 serving pipelines of the positional ResNet trunks of the
dense-prediction models (counterpart of
``pytorchcv_tpu.quant.seg_backbone_int8``): the dilated ResNet(D)
segmentation backbone (``prepare_int8_seg_backbone``) and the plain ResNet
trunk of SimplePose, CenterNet and AlphaPose (``prepare_int8_plain_trunk``).

Both trunks have children "0" (the stem) and "1".."4" (stages of units).
As in ``resnet_int8``, weights are quantized and BN folded once,
activations are int8 NHWC between convs, and every scalar is derived once
with the JAX pipeline's float32 roundings, so the outputs match it bit for
bit on the same weights and scales:

* stem: planar bf16 image -> folded bf16 conv, bias, ReLU, quant (kernel
  K3): the SENet deep stem's 3x3/s2 conv1, then its int8 conv2 and conv3
  (K2); or ``ResInitBlock``'s 7x7/s2 conv; then the int8 max-pool
  (``maxpool_i8``);
* every unit conv on K2 alone (no K8 chains, as in the JAX trunks); with
  ``bend`` the last unit of stage 3 also writes the bf16 "bend" in the same
  launch as its int8 output; an SE unit (AlphaPose's Fast-SE-ResNet) runs
  its gate (``kernels.se_tail.se_gate``) and its tail on K11.

The segmentation backbone is dilated (stride 2 only at stage 2 unit 1,
stages 3 and 4 at dilation 2 and 4), the plain trunk strided (stride 2 at
the first unit of stages 2-4); both put a bottleneck's stride on its 3x3.
Each stride and dilation is read from the model, and one that differs from
its trunk's geometry raises ``UnsupportedTreeError``.

``prepare_int8_seg_backbone``'s ``fn(plan, x) -> (stage4, bend)``, both bf16
NHWC (the bend None when the plan was built without it);
``prepare_int8_plain_trunk``'s ``fn(plan, x) -> stage4`` bf16 NHWC.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.stem import maxpool_i8, stem_conv
from ..nn.conv import ConvBlock
from .resnet_int8 import (UnsupportedTreeError, _cell_consts, _conv_step,
                          _f32, _folded_stem_kernel, _param_children,
                          _planar_bf16, _run_step, _se_consts, _unit,
                          _unit_plan)

__all__ = ["is_seg_resnetd_backbone", "prepare_int8_seg_backbone",
           "is_plain_resnet_trunk", "prepare_int8_plain_trunk"]

_STAGES = ("1", "2", "3", "4")
_BEND_STAGE = 3              # the stage whose output the head also takes
_UNIT_BRANCHES = {"body", "identity_conv", "activ", "se"}


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


def is_plain_resnet_trunk(model: nn.Module) -> bool:
    """True for a model whose ``backbone`` is a plain positional ResNet(-b)
    trunk, decided on the parameter-holding children as JAX
    ``is_plain_resnet_trunk`` decides on the parameter tree: children
    "0".."4"; a stem of one conv block (``ResInitBlock``); in every stage a
    ``unit1``; in every unit a ``body`` whose ``conv1`` holds a conv and a
    BN, no ``identity_block`` (ResNet-A's pooled downsample), an SE gate
    only of ``{conv1, conv2}`` or ``{fc1, fc2}``, and no grouped 3x3 in a
    bottleneck; BN statistics in the backbone."""
    bb = getattr(model, "backbone", None)
    if not isinstance(bb, nn.Module) or \
            _param_children(bb) != {"0", *_STAGES}:
        return False
    init = bb[0]
    if _param_children(init) != {"conv"} or \
            "conv" not in _param_children(init.conv):
        return False
    for sk in _STAGES:
        stage = getattr(bb, sk)
        names = _param_children(stage)
        if "unit1" not in names:
            return False
        for uname in names:
            unit = getattr(stage, uname)
            branches = _param_children(unit)
            if "body" not in branches or "identity_block" in branches:
                return False
            if "se" in branches:
                se = _param_children(unit.se)
                if not ({"conv1", "conv2"} <= se or {"fc1", "fc2"} <= se):
                    return False
            body = _param_children(unit.body)
            if "conv1" not in body or not {"conv", "bn"} <= \
                    _param_children(unit.body.conv1):
                return False
            if "conv3" in body and unit.body.conv2.conv.weight.shape[1] != \
                    unit.body.conv1.conv.weight.shape[0]:
                return False
    return any(isinstance(m, nn.BatchNorm2d) for m in bb.modules())


def _unit_geometry_dilated(si: int, uj: int) -> Tuple[int, int]:
    """(stride, dilation) of the 3x3 in stage ``si``, unit ``uj`` (both
    1-based; reference resnetd.py:47-48)."""
    stride = 2 if (si == 2 and uj == 1) else 1
    dilation = 2 ** max(0, (si - 1) - 1 - int(uj == 1))
    return stride, dilation


def _unit_geometry_plain(si: int, uj: int) -> Tuple[int, int]:
    """(stride, dilation) of the plain trunk (reference resnet.py:294):
    stride 2 at unit 1 of stages 2-4, never dilated."""
    return (2 if (si != 1 and uj == 1) else 1), 1


def _check_geometry(unit: nn.Module, prefix: str,
                    geometry: Tuple[int, int]) -> None:
    """The strides and dilations the JAX trunk assumes: a bottleneck's
    stride and dilation on its 3x3 (conv2), a basic block's stride on its
    conv1, the identity conv at the unit's stride; every other conv at
    stride 1, dilation 1."""
    stride, dilation = geometry
    bottleneck = hasattr(unit.body, "conv3")
    want = {"body/conv2": geometry} if bottleneck else \
        {"body/conv1": (stride, 1)}
    if unit.identity_conv is not None:
        want["identity_conv"] = (stride, 1)
    convs = {f"body/{n}": blk for n, blk in unit.body.named_children()}
    if unit.identity_conv is not None:
        convs["identity_conv"] = unit.identity_conv
    for name, blk in convs.items():
        got = (blk.conv.stride[0], blk.conv.dilation[0])
        if got != want.get(name, (1, 1)):
            raise UnsupportedTreeError(
                f"{prefix}/{name}: stride/dilation {got} differs from the "
                f"trunk's geometry {want.get(name, (1, 1))}")


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


def _trunk_plan(model: nn.Module, scales: Dict[str, float],
                geometry: Callable, bend: bool) -> Dict:
    """K3, K2 and K11 operands of ``model.backbone``: the stem (the deep
    stem or ``ResInitBlock``'s conv), then every unit with its geometry
    checked; with ``bend`` the last unit of stage 3 also writes the bend."""
    sc = scales.__getitem__
    bb = model.backbone
    stem = bb[0]
    s_u1 = sc("backbone/1/unit1/body/conv1/conv")
    if hasattr(stem, "conv1"):
        s_c2 = sc("backbone/0/conv2/conv")
        s_c3 = sc("backbone/0/conv3/conv")
        first, q0 = stem.conv1, _f32(127.0 / s_c2)
        stem_convs = [
            _conv_step(_cell_consts(stem.conv2, "backbone/0/conv2"),
                       s_c2, True, s_c3),
            _conv_step(_cell_consts(stem.conv3, "backbone/0/conv3"),
                       s_c3, True, s_u1)]
        first_path = "backbone/0/conv1"
    else:
        first, q0, stem_convs = stem.conv, _f32(127.0 / s_u1), []
        first_path = "backbone/0/conv"
    plan = {"stem": {"kf": _folded_stem_kernel(first),
                     "bias": _cell_consts(first, first_path)["bias"],
                     "q": q0},
            "stem_convs": stem_convs, "units": []}
    s_in = s_u1
    for si in range(1, 5):
        units = list(getattr(bb, str(si)).named_children())
        for uj, (uname, unit) in enumerate(units, start=1):
            prefix = f"backbone/{si}/{uname}"
            extra = set(n for n, _ in unit.named_children()) - _UNIT_BRANCHES
            if extra:
                raise UnsupportedTreeError(
                    f"{prefix}: branches {sorted(extra)} are not walked")
            _check_geometry(unit, prefix, geometry(si, uj))
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
            if getattr(unit, "se", None) is not None:
                uq["se"] = _se_consts(unit.se, f"{prefix}/se")
            u = _unit_plan(uq, f"{prefix}/body", s_in, s_next, sc)
            u["bend"] = bend and si == _BEND_STAGE and uj == len(units)
            plan["units"].append(u)
            if s_next is not None:
                s_in = s_next
    return plan


def prepare_int8_seg_backbone(model: nn.Module, scales: Dict[str, float],
                              bend: Optional[bool] = None
                              ) -> Tuple[Callable, Dict]:
    """Quantize the dilated segmentation backbone of ``model`` once; return
    ``(fn, plan)`` with ``fn(plan, x) -> (stage4, stage3_bend)``, both bf16
    NHWC; without ``bend`` (a head that reads stage 4 only) the bend is
    None and never written. ``bend`` defaults to the head's own
    ``reads_bend``. ``scales``: {path: amax} from
    ``calibrate_int8`` (or the JAX package's: the keys are the same). A conv
    whose stride or dilation differs from ``_unit_geometry_dilated``
    raises."""
    if not is_seg_resnetd_backbone(model):
        raise UnsupportedTreeError(
            "not a positional ResNet(D)-b deep-stem backbone")
    with torch.no_grad():
        plan = _trunk_plan(model, scales, _unit_geometry_dilated,
                           model.reads_bend if bend is None else bend)
    return _forward, plan


def _forward_plain(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    return _forward(plan, x)[0]


def prepare_int8_plain_trunk(model: nn.Module, scales: Dict[str, float]
                             ) -> Tuple[Callable, Dict]:
    """Quantize the plain ResNet trunk of ``model`` (SimplePose, CenterNet,
    AlphaPose) once; return ``(fn, plan)`` with ``fn(plan, x) -> stage4``
    bf16 NHWC. A conv whose stride or dilation differs from
    ``_unit_geometry_plain`` raises (a bottleneck built with
    ``conv1_stride=True``, whose stride the JAX trunk would move)."""
    if not is_plain_resnet_trunk(model):
        raise UnsupportedTreeError("not a plain positional ResNet trunk")
    with torch.no_grad():
        plan = _trunk_plan(model, scales, _unit_geometry_plain, False)
    return _forward_plain, plan
