"""int8 ResNet serving pipeline (counterpart of
``pytorchcv_tpu.quant.resnet_int8``).

Activations are stored int8 NHWC between layers (channels contiguous: the
GEMM's K dimension). Weights are quantized once per output channel, BN is
folded into a per-channel gain and bias, and every scalar the JAX pipeline
derives from the calibrated scales is derived here once, at prepare time,
with the same float32 roundings, so the int8 tensors match the JAX
pipeline's bit for bit on the same weights and scales:

* stem: planar bf16 image -> folded bf16 7x7/s2 conv, bias, ReLU, quant
  (kernel K3), then the int8 3x3/s2 max-pool (``maxpool_i8``);
* every unit conv: int8 conv with its ``_cell`` epilogue (kernel K2); the
  unit's last conv also runs the bf16-domain residual tail (add, ReLU,
  requantize to the next unit's scale, or bf16 after the last unit);
* chain steps: each maximal run of consecutive units that K8 takes
  (``_chainable``: no identity conv, an int8 output, and a 1x1 / 3x3 / 1x1
  body with every stride 1 and widths K8 takes,
  ``kernels.fused_bottleneck.takes_unit``) is one step on K8, whose
  arithmetic is the K2 chain's, so the logits do not change by a bit.
  Which units chain is decided here, once; at run time a chain step runs
  K8 or raises;
* head: mean-pool and the FC layer in f32 (``torch.mean``, ``torch.matmul``).

BN-less cells (the ImageNet WRN family: conv + bias, no norm) fold to gain
``s_w`` and the conv's bias, as in the JAX package. Trees this pipeline does
not walk (SE gates, the deep SENet stem, grouped convs) raise
``UnsupportedTreeError``; the deep-stem, dilated segmentation trunk has its
own pipeline, ``seg_backbone_int8``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels._build import f32 as _f32, no_tf32
from ..kernels.fused_bottleneck import (fused_bottleneck_chain,
                                        pack_units, takes_unit)
from ..kernels.int8_conv import int8_conv
from ..kernels.stem import maxpool_i8, stem_conv
from ..nn.conv import ConvBlock

__all__ = ["prepare_int8_resnet", "UnsupportedTreeError"]

_EPS = 1e-5


class UnsupportedTreeError(NotImplementedError):
    """A model whose structure the port's int8 pipeline does not serve."""


def _cell_consts(block: ConvBlock, path: str) -> Dict[str, torch.Tensor]:
    """Fold a conv + BN block into {wq int8 (Cout,kh,kw,Cin), gain, bias},
    rounding as the JAX package's jitted fold does on XLA: the division by
    127 is a product with f32(1 / 127), and ``beta - mean * g`` is one fused
    multiply-add (its exact product is taken in float64). A BN-less cell
    (WRN, reference wrn.py:12) folds to gain ``s_w`` and the conv's bias, or
    zeros (JAX ``_cell_consts``)."""
    conv, bn = block.conv, getattr(block, "bn", None)
    if conv.groups != 1:
        raise UnsupportedTreeError(f"{path}: grouped conv is not yet ported")
    if bn is not None and (bn.running_mean is None or
                           bn.running_var is None):
        raise ValueError(f"{path}: BatchNorm has no running statistics; "
                         f"the int8 pipeline folds them into the conv")
    kernel = conv.weight.detach().to(torch.float32).permute(0, 2, 3, 1)
    s_w = torch.clamp_min(kernel.abs().amax(dim=(1, 2, 3)), 1e-12) * \
        _f32(1.0 / 127.0)
    wq = torch.clamp(torch.round(kernel / s_w[:, None, None, None]),
                     -127, 127).to(torch.int8).contiguous()
    cell = {"wq": wq, "stride": conv.stride[0],
            "dilation": conv.dilation[0]}
    if bn is None:
        bias = torch.zeros_like(s_w) if conv.bias is None else \
            conv.bias.detach().to(torch.float32)
        return dict(cell, gain=s_w, bias=bias)
    g = bn.weight.detach().to(torch.float32) * torch.rsqrt(
        bn.running_var.to(torch.float32) + _EPS)
    bias = (bn.bias.detach().to(torch.float64) -
            bn.running_mean.to(torch.float64) * g.to(torch.float64)
            ).to(torch.float32)
    return dict(cell, gain=s_w * g, bias=bias)


def _quantize_tree(model: nn.Module) -> Dict:
    """{"init_block": {"conv": cell}, "stageN": {"unitM": {"body": {convK:
    cell}, ["identity_conv": cell]}}} for every conv cell of ``features``."""
    f = model.features
    if not hasattr(f, "init_block") or not isinstance(
            getattr(f.init_block, "conv", None), ConvBlock):
        raise UnsupportedTreeError("deep (3-conv) stem is not yet ported")
    out = {"init_block": {"conv": _cell_consts(
        f.init_block.conv, "features/init_block/conv")}}
    for sname, stage in f.named_children():
        if not sname.startswith("stage"):
            continue
        out[sname] = {}
        for uname, unit in stage.named_children():
            prefix = f"features/{sname}/{uname}"
            if set(n for n, _ in unit.named_children()) - {
                    "body", "identity_conv", "activ"}:
                raise UnsupportedTreeError(
                    f"{prefix}: unit with extra branches (e.g. SE) is not "
                    f"yet ported")
            body = {name: _cell_consts(blk, f"{prefix}/body/{name}")
                    for name, blk in unit.body.named_children()}
            uq = {"body": body}
            if unit.identity_conv is not None:
                uq["identity_conv"] = _cell_consts(
                    unit.identity_conv, f"{prefix}/identity_conv")
            out[sname][uname] = uq
    return out


def _resolve_conv1_stride(model: nn.Module,
                          conv1_stride: Optional[bool]) -> Optional[bool]:
    """The model's own stride placement (None for basic-block ResNets). An
    explicit value that contradicts the model raises: the pipeline reads the
    strides from the model and never computes another network."""
    own = None
    for m in model.modules():
        if hasattr(m, "conv1_stride"):
            own = m.conv1_stride
            break
    if conv1_stride is not None and own is not None and conv1_stride != own:
        raise ValueError(f"conv1_stride={conv1_stride} contradicts the "
                         f"model, built with conv1_stride={own}")
    return own


def _conv_step(cell: Dict, s_in: float, relu: bool,
               s_out: Optional[float], stride: Optional[int] = None) -> Dict:
    """One K2 call's operands: A = gain * f32(s_in / 127), B = bias,
    q = f32(127 / s_out) (None: bf16 output)."""
    return {"w": cell["wq"], "a": cell["gain"] * _f32(s_in / 127.0),
            "b": cell["bias"],
            "stride": cell["stride"] if stride is None else stride,
            "dilation": cell.get("dilation", 1), "relu": relu,
            "q": None if s_out is None else _f32(127.0 / s_out)}


def _run_step(step: Dict, x: torch.Tensor, **tail) -> torch.Tensor:
    return int8_conv(x, step["w"], step["a"], step["b"], stride=step["stride"],
                     relu=step["relu"], q=step["q"],
                     dilation=step["dilation"], **tail)


def _cell(xq: torch.Tensor, s_in: float, cell: Dict, stride: int = 1,
          relu: bool = True, s_out: Optional[float] = None) -> torch.Tensor:
    """int8 conv + folded BN (+ ReLU) (+ requant to int8 at amax
    ``s_out``; bf16 without it), on kernel K2."""
    return _run_step(_conv_step(cell, s_in, relu, s_out, stride), xq)


def _planar_bf16(x: torch.Tensor) -> torch.Tensor:
    """Planar (B, 3, H, W) or NHWC (B, H, W, 3) model input -> contiguous
    planar bf16, the stem kernel's layout."""
    if not (x.dim() == 4 and x.shape[1] == 3 and x.shape[-1] != 3):
        x = x.permute(0, 3, 1, 2)
    return x.to(torch.bfloat16).contiguous()


def _unit(u: Dict, xq: torch.Tensor, bend: bool = False):
    """One unit on K2: the body convs and the identity conv, then the last
    conv with the residual tail (int8 at the next unit's scale, or bf16
    after the last unit); with ``bend`` also its bf16 value."""
    ident = None
    if u["identity"] is not None:
        ident = _run_step(u["identity"], xq)
    t = xq
    for step in u["body"]:
        t = _run_step(step, t)
    if ident is None:
        tail = dict(residual=xq, res_scale=u["res_scale"], round_res=True)
    elif ident.dtype == torch.int8:
        tail = dict(residual=ident, res_scale=u["res_scale"])
    else:
        tail = dict(residual=ident)
    return _run_step(u["last"], t, bend=bend, **tail)


def _forward(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x``: planar (B, 3, H, W) or NHWC (B, H, W, 3) model input ->
    bf16 logits (B, classes)."""
    st = plan["stem"]
    xq = maxpool_i8(stem_conv(_planar_bf16(x), st["kf"], st["bias"],
                              st["q"]))
    out = None
    for u in plan["units"]:
        if "chain" in u:
            xq = fused_bottleneck_chain(xq, u["chain"])
            continue
        y = _unit(u, xq)
        if y.dtype == torch.int8:
            xq = y
        else:
            out = y
    feat = out.to(torch.float32).mean(dim=(1, 2))
    head = plan["head"]
    with no_tf32():
        logits = torch.matmul(feat, head["kernel"]) + head["bias"]
    return logits.to(torch.bfloat16)


def _folded_stem_kernel(block: ConvBlock) -> torch.Tensor:
    """The stem conv with its BN gain folded in (none without BN: JAX's g0
    = 1), bf16, input channel first: (3, k, k, Cout), the stem kernel's
    layout."""
    kernel = block.conv.weight.to(torch.float32)        # (O, 3, k, k)
    if block.bn is not None:
        g0 = block.bn.weight.to(torch.float32) * torch.rsqrt(
            block.bn.running_var.to(torch.float32) + _EPS)
        kernel = kernel * g0[:, None, None, None]
    return kernel.to(torch.bfloat16).permute(1, 2, 3, 0).contiguous()


def _unit_plan(uq: Dict, prefix: str, s_in: float, s_next: Optional[float],
               sc: Callable) -> Dict:
    """K2 operands of one unit (``uq`` from ``_quantize_tree``): its input
    has amax ``s_in``, its output is requantized at ``s_next`` (bf16 when
    None). The identity conv writes int8 at ``s_next`` (the JAX default
    ``q_identity=True``), or bf16 where no output scale exists."""
    names = sorted(uq["body"])          # conv1, conv2[, conv3]
    body = []
    s = s_in
    for name, nxt_name in zip(names, names[1:]):
        s_o = sc(f"{prefix}/{nxt_name}/conv")
        body.append(_conv_step(uq["body"][name], s, True, s_o))
        s = s_o
    last = _conv_step(uq["body"][names[-1]], s, False, s_next)
    ident, res_scale = None, _f32(s_in / 127.0)
    if "identity_conv" in uq:
        ident = _conv_step(uq["identity_conv"], s_in, False, s_next)
        res_scale = None if s_next is None else _f32(s_next / 127.0)
    return {"body": body, "last": last, "identity": ident,
            "res_scale": res_scale}


def _chainable(uq: Dict, s_next: Optional[float]) -> bool:
    """Whether K8 takes this unit (``uq`` from ``_quantize_tree``): no
    identity conv, an int8 output (``s_next`` given) and a body K8 takes
    (``takes_unit``: 1x1 / 3x3 / 1x1, every stride 1, no dilation, C and
    M within ``fits``). Grouped convs and SE raise at the tree walk."""
    return ("identity_conv" not in uq and s_next is not None
            and sorted(uq["body"]) == ["conv1", "conv2", "conv3"]
            and takes_unit(uq["body"]))


def prepare_int8_resnet(model: nn.Module, scales: Dict[str, float],
                        conv1_stride: Optional[bool] = None,
                        chains: bool = True) -> Tuple[Callable, Dict]:
    """Serving entry point: quantize weights once and return
    ``(infer_fn, plan)`` with ``infer_fn(plan, x) -> bf16 logits``.

    ``scales``: {path: amax} from ``calibrate_int8`` (or the JAX package's,
    which uses the same keys). ``chains``: run each maximal run of
    ``_chainable`` units as one K8 chain step (the default); False keeps
    every unit on K2 (the same logits)."""
    _resolve_conv1_stride(model, conv1_stride)
    sc = scales.__getitem__
    with torch.no_grad():
        qf = _quantize_tree(model)
        s_u1 = sc("features/stage1/unit1/body/conv1/conv")
        plan = {"stem": {"kf": _folded_stem_kernel(
                             model.features.init_block.conv),
                         "bias": qf["init_block"]["conv"]["bias"],
                         "q": _f32(127.0 / s_u1)},
                "units": []}
        run, run_scales = [], []        # the pending chain and its scales

        def close_chain():
            if run:
                plan["units"].append({"chain": pack_units(run, run_scales)})
                run.clear()
                run_scales.clear()

        stage_names = sorted(k for k in qf if k.startswith("stage"))
        s_in = s_u1
        for si, stage in enumerate(stage_names):
            unit_names = sorted(qf[stage], key=lambda u: int(u[4:]))
            for ui, unit in enumerate(unit_names):
                if ui + 1 < len(unit_names):
                    nxt = f"features/{stage}/{unit_names[ui + 1]}/body/conv1/conv"
                elif si + 1 < len(stage_names):
                    nxt = f"features/{stage_names[si + 1]}/unit1/body/conv1/conv"
                else:
                    nxt = None
                s_next = sc(nxt) if nxt else None
                uq, prefix = qf[stage][unit], f"features/{stage}/{unit}/body"
                if chains and _chainable(uq, s_next):
                    if not run:
                        run_scales.append(s_in)
                    run.append(uq["body"])
                    run_scales += [sc(f"{prefix}/conv2/conv"),
                                   sc(f"{prefix}/conv3/conv"), s_next]
                else:
                    close_chain()
                    plan["units"].append(_unit_plan(uq, prefix, s_in, s_next,
                                                    sc))
                if s_next is not None:
                    s_in = s_next
        close_chain()
        fc = model.output
        plan["head"] = {
            "kernel": fc.weight.t().to(torch.bfloat16).to(torch.float32)
            .contiguous(),
            "bias": fc.bias.detach().to(torch.float32)}
    return _forward, plan
