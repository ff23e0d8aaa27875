"""int8 MobileNet v1 and v2 serving pipelines (counterpart of
``pytorchcv_tpu.quant.mobilenet_int8``).

Activations are stored int8 NHWC between layers; weights are quantized
once per output channel and BN folded into a per-channel gain and bias
(``resnet_int8._cell_consts``); every scalar the JAX pipeline derives from
the calibrated scales is derived here once, with the same float32
roundings, so the int8 maps match the JAX pipeline's bit for bit on the
same weights and scales (the stem's f32 sums aside: K3 adds its products in
another order).

* v2 (``mobilenetv2*``, ``mobilenetv2b*``; JAX ``_forward``, :100-157): the
  folded bf16 3x3/s2 stem, bias, ``clip(0, 6)``, quant (K3); per unit the
  1x1 expansion with ReLU6 and requant (K2), the depthwise 3x3 with ReLU6
  and requant (K12), the linear 1x1 projection (K2), whose residual, where
  the unit has one, is added in f32 before the requant (K2's linear
  residual); the final block with ReLU6 in f32 (K2's f32 output); the mean
  over H, W and the 1x1 head as an f32 product (``torch.matmul``).
* v1 (``mobilenet*``, ``fdmobilenet*``; JAX ``_forward_v1``, :201-242):
  the stem with ReLU (K3), per unit the depthwise 3x3 (K12) and the
  pointwise 1x1 (K2), both ReLU and requant, the last pointwise conv in
  f32; the mean and the dense head.

Unit strides are read from the model. K2 takes Cin % 4 == 0: where a
projection writes a map whose width is not a multiple of 4
(``mobilenetv2_w3d4``'s 18 channels, ``mobilenetv2_wd4``'s 6), ``prepare``
pads it with zero channels (zero weights, gain and bias: they quantize to
0) and gives the convs that read it matching zero weights, so the logits
do not change; the residual test compares the model's own widths. Not
ported: JAX's ``dw_bf16=True`` variant (the depthwise conv in bf16); the
route runs JAX's default, the int8 depthwise conv.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels._build import f32 as _f32, no_tf32
from ..kernels.dwconv_i8 import dwconv_i8
from ..kernels.int8_conv import int8_conv
from ..kernels.stem import stem_conv
from ..nn.conv import ConvBlock
from .resnet_int8 import (_cell_consts, _folded_stem_kernel, _planar_bf16,
                          UnsupportedTreeError)

__all__ = ["is_mobilenet_v1_tree", "is_mobilenet_v2_tree",
           "prepare_int8_mobilenet", "prepare_int8_mobilenet_v1"]


def _conv_bn(block) -> bool:
    return (isinstance(block, ConvBlock) and block.bn is not None
            and isinstance(block.bn, nn.BatchNorm2d))


def _depthwise(block) -> bool:
    return isinstance(block, ConvBlock) and block.conv.weight.shape[1] == 1


def _stages(model):
    f = getattr(model, "features", None)
    if f is None:
        return None, []
    return f, [(n, m) for n, m in f.named_children() if n.startswith("stage")]


def is_mobilenet_v2_tree(model: nn.Module) -> bool:
    """True when ``model`` has the LinearBottleneck layout the v2 pipeline
    serves (JAX ``is_mobilenet_v2_tree``): a conv + BN stem, a final block,
    units of {conv1?, conv2 (depthwise), conv3}, a 1x1-conv head."""
    f, stages = _stages(model)
    if f is None or not _conv_bn(getattr(f, "init_block", None)) or \
            not hasattr(f, "final_block") or not stages:
        return False
    for _, stage in stages:
        for unit in stage.children():
            names = {n for n, _ in unit.named_children()}
            if not names <= {"conv1", "conv2", "conv3"} or \
                    not {"conv2", "conv3"} <= names:
                return False
            if not _depthwise(unit.conv2):
                return False
    return isinstance(getattr(model, "output", None), nn.Conv2d)


def is_mobilenet_v1_tree(model: nn.Module) -> bool:
    """True for the depthwise-separable v1 layout (JAX
    ``is_mobilenet_v1_tree``): a conv + BN stem, units of {dw_conv,
    pw_conv} whose depthwise conv has BN (not ``mobilenetb``'s), a dense
    head."""
    f, stages = _stages(model)
    if f is None or not _conv_bn(getattr(f, "init_block", None)) or \
            not stages:
        return False
    for _, stage in stages:
        for unit in stage.children():
            if {n for n, _ in unit.named_children()} != {"dw_conv",
                                                         "pw_conv"}:
                return False
            if not _depthwise(unit.dw_conv) or not _conv_bn(unit.dw_conv):
                return False
    return isinstance(getattr(model, "output", None), nn.Linear)


def _v1_unit_strides(model: nn.Module) -> Dict[Tuple[str, str], int]:
    """Each v1 unit's stride, read from its depthwise conv
    (``first_stage_stride`` differs between MobileNet and FD-MobileNet)."""
    _, stages = _stages(model)
    return {(sname, uname): unit.dw_conv.conv.stride[0]
            for sname, stage in stages
            for uname, unit in stage.named_children()}


def _round4(c: int) -> int:
    return -(-c // 4) * 4


def _pad_cell(cell: Dict, cout: int, cin: Optional[int] = None) -> Dict:
    """``cell`` with zero output channels up to ``cout`` (zero weights, gain
    and bias) and, for a dense conv, zero input channels up to ``cin``."""
    wq, gain, bias = cell["wq"], cell["gain"], cell["bias"]
    extra = cout - wq.shape[0]
    if extra:
        wq = torch.cat([wq, wq.new_zeros((extra, *wq.shape[1:]))])
        gain = torch.cat([gain, gain.new_zeros(extra)])
        bias = torch.cat([bias, bias.new_zeros(extra)])
    if cin is not None and cin > wq.shape[3]:
        wq = torch.cat([wq, wq.new_zeros((*wq.shape[:3], cin - wq.shape[3]))],
                       dim=3)
    return dict(cell, wq=wq.contiguous(), gain=gain, bias=bias)


def _k2_step(cell: Dict, s_in: float, s_out: Optional[float],
             act: Optional[str] = None) -> Dict:
    """A K2 call's operands (the 1x1 convs): A = gain * f32(s_in / 127),
    B = bias, q = f32(127 / s_out); no ``s_out``: f32 output."""
    return {"w": cell["wq"], "a": cell["gain"] * _f32(s_in / 127.0),
            "b": cell["bias"], "act": act,
            "q": None if s_out is None else _f32(127.0 / s_out)}


def _k12_step(cell: Dict, s_in: float, s_out: float, stride: int,
              act: str) -> Dict:
    """A K12 call's operands: the depthwise weights as (3, 3, C)."""
    if tuple(cell["wq"].shape[1:]) != (3, 3, 1):
        raise UnsupportedTreeError(f"depthwise kernel "
                                   f"{tuple(cell['wq'].shape)}; the "
                                   f"pipeline takes 3x3")
    return {"w": cell["wq"][:, :, :, 0].permute(1, 2, 0).contiguous(),
            "a": cell["gain"] * _f32(s_in / 127.0), "b": cell["bias"],
            "q": _f32(127.0 / s_out), "stride": stride, "act": act}


def _k2(step: Dict, x: torch.Tensor, **tail) -> torch.Tensor:
    return int8_conv(x, step["w"], step["a"], step["b"], stride=1,
                     act=step["act"], q=step["q"],
                     out_f32=step["q"] is None, **tail)


def _k12(step: Dict, x: torch.Tensor) -> torch.Tensor:
    return dwconv_i8(x, step["w"], step["a"], step["b"], step["q"],
                     step["stride"], step["act"])


def _stem(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    st = plan["stem"]
    return stem_conv(_planar_bf16(x), st["kf"], st["bias"], st["q"],
                     st["act"])


def _head(head: Dict, feat: torch.Tensor) -> torch.Tensor:
    with no_tf32():
        logits = torch.matmul(feat, head["kernel"])
    if head["bias"] is not None:
        logits = logits + head["bias"]
    return logits.to(torch.bfloat16)


def _forward_v2(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x``: planar (B, 3, H, W) or NHWC (B, H, W, 3) model input -> bf16
    logits (B, classes)."""
    xq = _stem(plan, x)
    for u in plan["units"]:
        t = xq if u["expand"] is None else _k2(u["expand"], xq)
        t = _k12(u["dw"], t)
        if u["res_scale"] is None:
            xq = _k2(u["project"], t)
        else:
            xq = _k2(u["project"], t, residual=xq, res_scale=u["res_scale"],
                     linear_res=True)
    y = _k2(plan["final"], xq)
    return _head(plan["head"], y.mean(dim=(1, 2)))


def _forward_v1(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    """As :func:`_forward_v2`, for the v1 plan."""
    xq = _stem(plan, x)
    for u in plan["units"]:
        xq = _k2(u["pw"], _k12(u["dw"], xq))
    return _head(plan["head"], xq.mean(dim=(1, 2)))


def _stem_plan(model: nn.Module, s_first: float, act: str) -> Dict:
    ib = model.features.init_block
    return {"kf": _folded_stem_kernel(ib),
            "bias": _cell_consts(ib, "features/init_block")["bias"],
            "q": _f32(127.0 / s_first), "act": act}


def _head_plan(weight: torch.Tensor, bias) -> Dict:
    """The head's (Cin, classes) kernel, rounded to bf16 as the JAX
    pipeline stores it, and its f32 bias (None without one)."""
    kernel = weight.detach().reshape(weight.shape[0], -1).t()
    return {"kernel": kernel.to(torch.bfloat16).to(torch.float32)
            .contiguous(),
            "bias": None if bias is None else bias.detach().to(torch.float32)}


def prepare_int8_mobilenet(model: nn.Module, scales: Dict[str, float]
                           ) -> Tuple[Callable, Dict]:
    """The v2 pipeline: quantize weights once and return ``(infer_fn,
    plan)`` with ``infer_fn(plan, x) -> bf16 logits``. ``scales``:
    {path: amax} from ``calibrate_int8`` (or the JAX package's)."""
    if not is_mobilenet_v2_tree(model):
        raise UnsupportedTreeError("not a MobileNetV2 tree")
    sc = scales.__getitem__
    _, stages = _stages(model)
    units = [(f"features/{sn}/{un}", u) for sn, st in stages
             for un, u in st.named_children()]

    def first_key(prefix, unit):
        return f"{prefix}/{'conv1' if unit.conv1 is not None else 'conv2'}" \
               f"/conv"

    with torch.no_grad():
        s_in = sc(first_key(*units[0]))
        plan = {"stem": _stem_plan(model, s_in, "relu6"), "units": []}
        c_map = model.features.init_block.conv.out_channels
        for idx, (prefix, unit) in enumerate(units):
            s_next = sc(first_key(*units[idx + 1])) if idx + 1 < len(units) \
                else sc("features/final_block/conv")
            s_dw, s_pj = sc(f"{prefix}/conv2/conv"), sc(f"{prefix}/conv3/conv")
            expand, s_t, c_mid = None, s_in, c_map
            if unit.conv1 is not None:
                cell = _cell_consts(unit.conv1, f"{prefix}/conv1")
                c_mid = _round4(cell["wq"].shape[0])
                expand = _k2_step(_pad_cell(cell, c_mid, c_map), s_in, s_dw,
                                  "relu6")
                s_t = s_dw
            dw = _k12_step(_pad_cell(_cell_consts(unit.conv2,
                                                  f"{prefix}/conv2"), c_mid),
                           s_t, s_pj, unit.conv2.conv.stride[0], "relu6")
            cell = _cell_consts(unit.conv3, f"{prefix}/conv3")
            c_out = _round4(cell["wq"].shape[0])
            project = _k2_step(_pad_cell(cell, c_out, c_mid), s_pj, s_next)
            plan["units"].append({
                "expand": expand, "dw": dw, "project": project,
                "res_scale": _f32(s_in / 127.0) if unit.residual else None})
            s_in, c_map = s_next, c_out
        final = model.features.final_block
        plan["final"] = _k2_step(
            _pad_cell(_cell_consts(final, "features/final_block"),
                      final.conv.out_channels, c_map), s_in, None, "relu6")
        plan["head"] = _head_plan(model.output.weight, model.output.bias)
    return _forward_v2, plan


def prepare_int8_mobilenet_v1(model: nn.Module, scales: Dict[str, float]
                              ) -> Tuple[Callable, Dict]:
    """The v1 (depthwise-separable) pipeline: quantize weights once and
    return ``(infer_fn, plan)``, as :func:`prepare_int8_mobilenet`."""
    if not is_mobilenet_v1_tree(model):
        raise UnsupportedTreeError("not a MobileNet v1 tree")
    sc = scales.__getitem__
    strides = _v1_unit_strides(model)
    _, stages = _stages(model)
    units = [(sn, un, u) for sn, st in stages for un, u in st.named_children()]
    with torch.no_grad():
        s_in = sc(f"features/{units[0][0]}/{units[0][1]}/dw_conv/conv")
        plan = {"stem": _stem_plan(model, s_in, "relu"), "units": []}
        for idx, (sn, un, unit) in enumerate(units):
            prefix = f"features/{sn}/{un}"
            s_pw = sc(f"{prefix}/pw_conv/conv")
            s_next = None
            if idx + 1 < len(units):
                s_next = sc(f"features/{units[idx + 1][0]}/"
                            f"{units[idx + 1][1]}/dw_conv/conv")
            plan["units"].append({
                "dw": _k12_step(_cell_consts(unit.dw_conv,
                                             f"{prefix}/dw_conv"), s_in,
                                s_pw, strides[(sn, un)], "relu"),
                "pw": _k2_step(_cell_consts(unit.pw_conv,
                                            f"{prefix}/pw_conv"), s_pw,
                               s_next, "relu")})
            s_in = s_next
        plan["head"] = _head_plan(model.output.weight, model.output.bias)
    return _forward_v1, plan
