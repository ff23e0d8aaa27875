"""int8 ResNet serving pipeline (counterpart of
``pytorchcv_tpu.quant.resnet_int8``).

Activations are stored int8 NHWC between layers (channels contiguous: the
GEMM's K dimension). Weights are quantized once per output channel, BN is
folded into a per-channel gain and bias, and every scalar the JAX pipeline
derives from the calibrated scales is derived here once, at prepare time,
with the same float32 roundings, so the int8 tensors match the JAX
pipeline's bit for bit on the same weights and scales:

* stem: planar bf16 image -> folded bf16 7x7/s2 conv, bias, ReLU, quant
  (kernel K3), then the int8 3x3/s2 max-pool (``maxpool_i8``); SENet's
  deep stem: the folded bf16 3x3/s2 conv1 + quant on K3, int8 conv2 and
  conv3 on K2, then ``maxpool_i8``;
* every unit conv: int8 conv with its ``_cell`` epilogue (kernel K2;
  ResNeXt's and SENet's grouped 3x3 on K2's grouped kernel, the stride
  read from the model as everywhere); the unit's last conv also runs the
  bf16-domain residual tail (add, ReLU, requantize to the next unit's
  scale, or bf16 after the last unit);
* SE units (SE-ResNet, SE-ResNeXt, SENet): the last conv writes bf16 (K2,
  no tail), the gate is plain torch (``kernels.se_tail.se_gate``: f32 mean,
  two products, ReLU, sigmoid; both the 1x1-conv and the dense
  parameterization), and the tail (gate product, residual add, ReLU,
  requantization) is kernel K11; the identity conv stays int8 at the next
  unit's scale;
* chain steps: each maximal run of consecutive units that K8 takes
  (``_chainable``: no identity conv, an int8 output, and a 1x1 / 3x3 / 1x1
  body with every stride 1 and widths K8 takes,
  ``kernels.fused_bottleneck.takes_unit``) is one step on K8, whose
  arithmetic is the K2 chain's, so the logits do not change by a bit.
  Which units chain is decided here, once; at run time a chain step runs
  K8 or raises;
* head: mean-pool and the FC layer in f32 (``torch.mean``, ``torch.matmul``;
  SENet's ``output.fc``).

BN-less cells (the ImageNet WRN family: conv + bias, no norm) fold to gain
``s_w`` and the conv's bias, as in the JAX package. ``is_plain_resnet_tree``
is the JAX package's check of a tree before this pipeline runs (JAX
``serve.py:_is_plain_resnet``); ``make_serving_fn`` serves a tree that
fails it in bf16. A unit with other
branches than body, identity conv, SE gate and activation, or an SE gate
with other activations than ReLU and sigmoid, raises
``UnsupportedTreeError``; the deep-stem, dilated segmentation trunk has its
own pipeline, ``seg_backbone_int8``. Not ported: the JAX ``q_residual``
branch and ``int8_resnet_apply_fn``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Set, Tuple

import torch
from torch import nn

from ..kernels._build import f32 as _f32, no_tf32
from ..kernels.fused_bottleneck import (fused_bottleneck_chain,
                                        pack_units, takes_unit)
from ..kernels.int8_conv import int8_conv
from ..kernels.se_tail import se_gate, se_tail
from ..kernels.stem import maxpool_i8, stem_conv
from ..nn.conv import ConvBlock

__all__ = ["prepare_int8_resnet", "is_plain_resnet_tree",
           "UnsupportedTreeError"]

_EPS = 1e-5


class UnsupportedTreeError(NotImplementedError):
    """A model whose structure the port's int8 pipeline does not serve."""


def _param_children(module: nn.Module) -> Set[str]:
    """Names of ``module``'s children that hold parameters: the keys of the
    JAX parameter tree at that node (a layer without parameters, as ReLU or
    a pool, leaves no key there)."""
    return {n for n, m in module.named_children()
            if next(m.parameters(), None) is not None}


def is_plain_resnet_tree(model: nn.Module) -> bool:
    """True when ``model`` has the zoo ResNet layout this pipeline serves,
    decided branch by branch as JAX ``serve.py:_is_plain_resnet`` decides
    on the parameter tree: no ``post_activ`` (the pre-activation family);
    a stem that is ``init_block.conv.conv``, or the deep conv1 / conv2 /
    conv3 stem with an SE gate in every unit (SENet's); stages whose
    units hold ``body.conv1.conv`` and no branch but ``body``,
    ``identity_conv`` and ``se``; SE gates of ``{conv1, conv2}`` or
    ``{fc1, fc2}``; and a ``Linear`` head at ``output`` or ``output.fc``.
    On the head it is stricter than JAX's check, which takes any
    ``kernel`` leaf there (a 1x1-conv head too): the pipeline's head is a
    matmul of the pooled features, so such a tree is served in bf16."""
    f = getattr(model, "features", None)
    if f is None:
        return False
    names = _param_children(f)
    if "post_activ" in names or "init_block" not in names:
        return False
    stages = [getattr(f, n) for n in sorted(names) if n.startswith("stage")]
    units = [getattr(st, u) for st in stages for u in _param_children(st)]
    stem = _param_children(f.init_block)
    if "conv" in stem:
        if "conv" not in _param_children(f.init_block.conv):
            return False
    elif stem != {"conv1", "conv2", "conv3"} or not all(
            "se" in _param_children(u) for u in units):
        return False
    if not stages:
        return False
    for u in units:
        branches = _param_children(u)
        if branches - {"body", "identity_conv", "se"}:
            return False
        if "body" not in branches or \
                "conv1" not in _param_children(u.body) or \
                "conv" not in _param_children(u.body.conv1):
            return False
        if "se" in branches and _param_children(u.se) not in (
                {"conv1", "conv2"}, {"fc1", "fc2"}):
            return False
    out = getattr(model, "output", None)
    return isinstance(out, nn.Linear) or \
        isinstance(getattr(out, "fc", None), nn.Linear)


def _cell_consts(block: ConvBlock, path: str) -> Dict[str, torch.Tensor]:
    """Fold a conv + BN block into {wq int8 (Cout,kh,kw,Cin), gain, bias},
    rounding as the JAX package's jitted fold does on XLA: the division by
    127 is a product with f32(1 / 127), and ``beta - mean * g`` is one fused
    multiply-add (its exact product is taken in float64). A BN-less cell
    (WRN, reference wrn.py:12) folds to gain ``s_w`` and the conv's bias, or
    zeros (JAX ``_cell_consts``)."""
    conv, bn = block.conv, getattr(block, "bn", None)
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
            "dilation": conv.dilation[0], "groups": conv.groups}
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


def _se_consts(se: nn.Module, path: str) -> Dict[str, torch.Tensor]:
    """An SE gate's two products as f32 {k1 (C, M), b1, k2 (M, C), b2}: 1x1
    convs ``conv1``/``conv2`` or dense ``fc1``/``fc2`` (JAX ``_se_gate``),
    between them ReLU, after them sigmoid."""
    acts = (type(getattr(se, "activ", None)), type(getattr(se, "sigmoid",
                                                             None)))
    if acts != (nn.ReLU, nn.Sigmoid):
        raise UnsupportedTreeError(f"{path}: SE gate with activations "
                                   f"{acts}; the pipeline takes ReLU, "
                                   f"sigmoid")
    first, second = (("conv1", "conv2") if hasattr(se, "conv1")
                     else ("fc1", "fc2"))
    out = {}
    for i, name in enumerate((first, second), start=1):
        layer = getattr(se, name)
        w = layer.weight.detach().to(torch.float32)
        out[f"k{i}"] = w.reshape(w.shape[0], w.shape[1]).t().contiguous()
        out[f"b{i}"] = layer.bias.detach().to(torch.float32)
    return out


def _quantize_tree(model: nn.Module) -> Dict:
    """{"init_block": {"conv": cell} (or {"conv1", "conv2", "conv3"}: the
    deep stem), "stageN": {"unitM": {"body": {convK: cell},
    ["identity_conv": cell], ["se": gate]}}} for every conv cell of
    ``features``."""
    f = model.features
    ib = getattr(f, "init_block", None)
    stem_names = ["conv"] if isinstance(getattr(ib, "conv", None),
                                        ConvBlock) else ["conv1", "conv2",
                                                         "conv3"]
    if not all(isinstance(getattr(ib, n, None), ConvBlock)
               for n in stem_names):
        raise UnsupportedTreeError("features.init_block is neither a conv "
                                   "block stem nor the deep 3-conv stem")
    out = {"init_block": {n: _cell_consts(getattr(ib, n),
                                          f"features/init_block/{n}")
                          for n in stem_names}}
    for sname, stage in f.named_children():
        if not sname.startswith("stage"):
            continue
        out[sname] = {}
        for uname, unit in stage.named_children():
            prefix = f"features/{sname}/{uname}"
            if set(n for n, _ in unit.named_children()) - {
                    "body", "identity_conv", "activ", "se"}:
                raise UnsupportedTreeError(
                    f"{prefix}: unit with branches other than body, "
                    f"identity conv and SE gate is not yet ported")
            body = {name: _cell_consts(blk, f"{prefix}/body/{name}")
                    for name, blk in unit.body.named_children()}
            uq = {"body": body}
            if unit.identity_conv is not None:
                uq["identity_conv"] = _cell_consts(
                    unit.identity_conv, f"{prefix}/identity_conv")
            if getattr(unit, "se", None) is not None:
                uq["se"] = _se_consts(unit.se, f"{prefix}/se")
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
            "dilation": cell.get("dilation", 1),
            "groups": cell.get("groups", 1), "act": "relu" if relu else None,
            "q": None if s_out is None else _f32(127.0 / s_out)}


def _run_step(step: Dict, x: torch.Tensor, **tail) -> torch.Tensor:
    return int8_conv(x, step["w"], step["a"], step["b"], stride=step["stride"],
                     act=step["act"], q=step["q"],
                     dilation=step["dilation"], groups=step["groups"],
                     **tail)


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
    after the last unit); with ``bend`` also its bf16 value. An SE unit's
    last conv writes bf16 and K11 runs the tail with the gate."""
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
    if "se" not in u:
        return _run_step(u["last"], t, bend=bend, **tail)
    if bend:
        raise ValueError("an SE unit has no bend output")
    t = _run_step(u["last"], t)
    return se_tail(t, se_gate(t, **u["se"]), q=u["q"], **tail)


def _forward(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x``: planar (B, 3, H, W) or NHWC (B, H, W, 3) model input ->
    bf16 logits (B, classes)."""
    st = plan["stem"]
    xq = stem_conv(_planar_bf16(x), st["kf"], st["bias"], st["q"])
    for step in plan["stem_convs"]:
        xq = _run_step(step, xq)
    xq = maxpool_i8(xq)
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
    ``q_identity=True``), or bf16 where no output scale exists. An SE
    unit's last conv writes bf16, and ``q`` is its tail's (K11's)."""
    names = sorted(uq["body"])          # conv1, conv2[, conv3]
    body = []
    s = s_in
    for name, nxt_name in zip(names, names[1:]):
        s_o = sc(f"{prefix}/{nxt_name}/conv")
        body.append(_conv_step(uq["body"][name], s, True, s_o))
        s = s_o
    se = uq.get("se")
    last = _conv_step(uq["body"][names[-1]], s, False,
                      None if se else s_next)
    ident, res_scale = None, _f32(s_in / 127.0)
    if "identity_conv" in uq:
        ident = _conv_step(uq["identity_conv"], s_in, False, s_next)
        res_scale = None if s_next is None else _f32(s_next / 127.0)
    u = {"body": body, "last": last, "identity": ident,
         "res_scale": res_scale}
    if se:
        u["se"] = se
        u["q"] = None if s_next is None else _f32(127.0 / s_next)
    return u


def _chainable(uq: Dict, s_next: Optional[float]) -> bool:
    """Whether K8 takes this unit (``uq`` from ``_quantize_tree``): no
    identity conv, no SE gate, an int8 output (``s_next`` given) and a
    body K8 takes (``takes_unit``: 1x1 / 3x3 / 1x1, every stride 1, no
    dilation, no groups, C and M within ``fits``)."""
    return ("identity_conv" not in uq and "se" not in uq
            and s_next is not None
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
        ib, qib = model.features.init_block, qf["init_block"]
        if "conv" in qib:
            plan = {"stem": {"kf": _folded_stem_kernel(ib.conv),
                             "bias": qib["conv"]["bias"],
                             "q": _f32(127.0 / s_u1)},
                    "stem_convs": []}
        else:
            # SENet's deep stem (JAX _forward :234-250): K3 to conv2's
            # scale, then conv2 and conv3 on K2.
            s2 = sc("features/init_block/conv2/conv")
            s3 = sc("features/init_block/conv3/conv")
            plan = {"stem": {"kf": _folded_stem_kernel(ib.conv1),
                             "bias": qib["conv1"]["bias"],
                             "q": _f32(127.0 / s2)},
                    "stem_convs": [
                        _conv_step(qib["conv2"], s2, True, s3),
                        _conv_step(qib["conv3"], s3, True, s_u1)]}
        plan["units"] = []
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
        if not isinstance(fc, nn.Linear):      # SENet nests it as fc
            fc = fc.fc
        plan["head"] = {
            "kernel": fc.weight.t().to(torch.bfloat16).to(torch.float32)
            .contiguous(),
            "bias": fc.bias.detach().to(torch.float32)}
    return _forward, plan
