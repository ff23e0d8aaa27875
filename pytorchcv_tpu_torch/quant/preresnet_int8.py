"""int8 serving pipeline of the pre-activation ResNets, PreResNet and
SE-PreResNet (counterpart of ``pytorchcv_tpu.quant.preresnet_int8``).

Each cell is BN -> ReLU -> conv and the residual stream is never bounded by
an activation, so the stream stays bf16 while every tensor inside a unit
body is int8. Weights are quantized once per output channel, as the JAX
package's jitted ``prep`` rounds them (the division by 127 a product with
f32(1 / 127), ``bias - mean * g`` one fused multiply-add); every scalar
derived from the calibrated scales is derived once with the JAX pipeline's
float32 roundings, so the int8 maps and the bf16 stream match the JAX
pipeline's bit for bit on the same weights and scales (the stem's f32 sums
aside: K3 adds its products in another order; SE units handed JAX's gate):

* stem: the unfolded bf16 7x7/s2 kernel on K3 with the per-channel gain,
  ``max(y * g + b, 0)`` written as bf16 (JAX ``_forward`` :123-135), then
  the 3x3/s2 pad-1 max-pool of the bf16 stream (``F.max_pool2d`` on the
  channels-last map: an XLA op in the JAX package, exact in any order);
* each unit: K13 turns the stream ``r`` into ``pre = quant(max(f32(r) *
  g1 + b1, 0))``, the pre-activation of the unit's conv1 (fused into the
  previous unit's stream step); every body conv but the last runs K2's
  pre-activation epilogue, ``t = acc * A`` with ``A = s_w * h_scale``, then
  the next conv's ``quant(max(t * G + B, 0))``; the last conv writes ``t``
  (f32; bf16 before an SE gate); the identity conv, where the unit has one,
  is an int8 conv of ``pre`` written in f32 (K2); K13 then forms ``r' =
  bf16(t' + id)``, with ``t' = bf16(f32(bf16(t)) * gate)`` in an SE unit
  (the gate: ``kernels.se_tail.se_gate``), and the next unit's ``pre``;
* head: ``max(f32(r) * gp + bp, 0)``, the mean over H and W and the dense
  layer in f32 (its kernel rounded to bf16 as JAX stores it).

Every stride is read from the model (not from the JAX package's rule on
the model's name). ``is_plain_preresnet_tree`` is JAX
``serve.py:_is_plain_preresnet`` on the module tree; ``make_serving_fn``
serves a tree that fails it in bf16.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._build import f32 as _f32
from ..kernels.int8_conv import int8_conv
from ..kernels.preact import preact
from ..kernels.se_tail import se_gate
from ..kernels.stem import stem_conv
from ..nn.conv import PreConvBlock
from .mobilenet_int8 import _head, _head_plan
from .resnet_int8 import (_EPS, UnsupportedTreeError, _param_children,
                          _planar_bf16, _se_consts)

__all__ = ["is_plain_preresnet_tree", "prepare_int8_preresnet"]


def _leaf_params(module: nn.Module):
    return {n for n, _ in module.named_parameters(recurse=False)}


def is_plain_preresnet_tree(model: nn.Module) -> bool:
    """True for the pre-activation layout the pipeline serves, decided as
    JAX ``serve.py:_is_plain_preresnet`` decides on the parameter tree:
    ``post_activ`` and an ``init_block`` of {bn, a bias-less conv}, units
    whose body's conv1 has a BN and whose branches are only ``body``,
    ``identity_conv`` (a bias-less conv) and ``se``, and an ``output``."""
    f = getattr(model, "features", None)
    if not isinstance(f, nn.Module):
        return False
    names = _param_children(f)
    if "post_activ" not in names or "init_block" not in names:
        return False
    ib = f.init_block
    if _param_children(ib) != {"bn", "conv"} or \
            _leaf_params(ib.conv) != {"weight"}:
        return False
    for sname in (n for n in names if n.startswith("stage")):
        stage = getattr(f, sname)
        for uname in _param_children(stage):
            unit = getattr(stage, uname)
            branches = _param_children(unit)
            body = getattr(unit, "body", None)
            if "body" not in branches or \
                    "conv1" not in _param_children(body) or \
                    "bn" not in _param_children(body.conv1):
                return False
            if branches - {"body", "identity_conv", "se"}:
                return False
            if "identity_conv" in branches and \
                    (_param_children(unit.identity_conv) or
                     _leaf_params(unit.identity_conv) != {"weight"}):
                return False
    out = getattr(model, "output", None)
    return out is not None and next(out.parameters(), None) is not None


def _qweights(conv: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(wq int8 (Cout, k, k, Cin), s_w)`` as JAX's jitted ``_qweights``
    rounds them: the abs-max times f32(1 / 127)."""
    kernel = conv.weight.detach().to(torch.float32).permute(0, 2, 3, 1)
    s_w = torch.clamp_min(kernel.abs().amax(dim=(1, 2, 3)), 1e-12) * \
        _f32(1.0 / 127.0)
    wq = torch.clamp(torch.round(kernel / s_w[:, None, None, None]),
                     -127, 127).to(torch.int8).contiguous()
    return wq, s_w


def _bn_affine(bn: nn.BatchNorm2d, fused: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(g, b)`` of eval-mode BN: ``g = gamma * rsqrt(var + eps)``, ``b =
    beta - mean * g``, one fused multiply-add as in JAX's jitted ``prep``
    (its exact product taken in float64), or with ``fused=False`` two
    roundings (JAX's eager fold of the stem)."""
    g = bn.weight.detach().to(torch.float32) * torch.rsqrt(
        bn.running_var.to(torch.float32) + _EPS)
    mean, beta = bn.running_mean.to(torch.float32), bn.bias.detach()
    if fused:
        b = (beta.to(torch.float64) - mean.to(torch.float64) *
             g.to(torch.float64)).to(torch.float32)
    else:
        b = beta.to(torch.float32) - mean * g
    return g, b


def _check_cell(block: nn.Module, path: str) -> None:
    if not isinstance(block, PreConvBlock) or block.bn is None or \
            not isinstance(block.activ, nn.ReLU) or \
            block.conv.bias is not None or block.conv.groups != 1 or \
            block.conv.dilation != (1, 1) or \
            block.conv.padding != (block.conv.kernel_size[0] // 2,) * 2:
        raise UnsupportedTreeError(f"{path}: the pipeline takes BN -> ReLU "
                                   f"-> bias-less conv cells, pad k // 2")


def _unit_plan(unit: nn.Module, prefix: str, sc: Callable) -> Dict:
    """The K2 operands of one unit's body and identity conv, its conv1's
    pre-activation ``bn1`` = (g, b) and scale ``q1``, and its SE gate."""
    names = sorted(_param_children(unit.body))
    if names not in (["conv1", "conv2"], ["conv1", "conv2", "conv3"]):
        raise UnsupportedTreeError(f"{prefix}/body: conv1, conv2[, conv3]")
    blocks = [getattr(unit.body, n) for n in names]
    for n, blk in zip(names, blocks):
        _check_cell(blk, f"{prefix}/body/{n}")
    s = [sc(f"{prefix}/body/{n}/conv") for n in names]
    affine = [_bn_affine(blk.bn) for blk in blocks]
    se = getattr(unit, "se", None)
    convs = []
    for i, blk in enumerate(blocks):
        wq, s_w = _qweights(blk.conv)
        step = {"w": wq, "a": s_w * _f32(s[i] / 127.0),
                "stride": blk.conv.stride[0]}
        if i + 1 < len(blocks):
            g, b = affine[i + 1]
            step.update(g=g, b=b, q=_f32(127.0 / s[i + 1]))
        else:
            step.update(b=torch.zeros_like(s_w), bf16=se is not None)
        convs.append(step)
    u = {"convs": convs, "bn1": affine[0], "q1": _f32(127.0 / s[0]),
         "identity": None, "se": None}
    idc = getattr(unit, "identity_conv", None)
    if idc is not None:
        if idc.kernel_size != (1, 1) or idc.bias is not None:
            raise UnsupportedTreeError(f"{prefix}/identity_conv: a bias-less "
                                       f"1x1 conv")
        wq, s_w = _qweights(idc)
        u["identity"] = {"w": wq, "a": s_w * _f32(s[0] / 127.0),
                         "b": torch.zeros_like(s_w), "stride": idc.stride[0]}
    if se is not None:
        u["se"] = _se_consts(se, f"{prefix}/se")
    return u


def _conv(step: Dict, x: torch.Tensor) -> torch.Tensor:
    """A body conv on K2: the pre-activation epilogue to int8, or the last
    conv's ``t = acc * A`` (f32, or bf16 before an SE gate)."""
    if "g" in step:
        return int8_conv(x, step["w"], step["a"], step["b"],
                         stride=step["stride"], act="relu", q=step["q"],
                         pre_gain=step["g"])
    return int8_conv(x, step["w"], step["a"], step["b"],
                     stride=step["stride"], act=None,
                     out_f32=not step.get("bf16", False))


def _pool_bf16(y: torch.Tensor) -> torch.Tensor:
    """3x3/s2 pad-1 max-pool of a bf16 NHWC map (-inf padding)."""
    p = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return p.permute(0, 2, 3, 1).contiguous()


def _forward(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x``: planar (B, 3, H, W) or NHWC (B, H, W, 3) model input -> bf16
    logits (B, classes)."""
    st = plan["stem"]
    r = _pool_bf16(stem_conv(_planar_bf16(x), st["kf"], st["b"], None,
                             "relu", stride=2, gain=st["g"]))
    units = plan["units"]
    _, pre = preact(r, bn=units[0]["bn1"], q=units[0]["q1"])
    for i, u in enumerate(units):
        h = pre
        for step in u["convs"]:
            h = _conv(step, h)
        ident = r if u["identity"] is None else int8_conv(
            pre, u["identity"]["w"], u["identity"]["a"], u["identity"]["b"],
            stride=u["identity"]["stride"], act=None, out_f32=True)
        gate = None if u["se"] is None else se_gate(h, **u["se"])
        nxt = units[i + 1] if i + 1 < len(units) else None
        r, pre = preact(h, ident, gate,
                        None if nxt is None else nxt["bn1"],
                        None if nxt is None else nxt["q1"])
    gp, bp = plan["post_activ"]
    out = torch.clamp_min(r.to(torch.float32) * gp + bp, 0.0)
    return _head(plan["head"], out.mean(dim=(1, 2)))


def prepare_int8_preresnet(model: nn.Module, scales: Dict[str, float]
                           ) -> Tuple[Callable, Dict]:
    """Serving entry point: quantize weights once and return ``(infer_fn,
    plan)`` with ``infer_fn(plan, x) -> bf16 logits``. ``scales``: {path:
    amax} from ``calibrate_int8`` (or the JAX package's)."""
    if not is_plain_preresnet_tree(model):
        raise UnsupportedTreeError("not a plain PreResNet tree")
    f = model.features
    ib = f.init_block
    if ib.conv.kernel_size != (7, 7) or ib.conv.stride != (2, 2) or \
            ib.conv.padding != (3, 3) or \
            not isinstance(getattr(ib, "activ", None), nn.ReLU):
        raise UnsupportedTreeError("features/init_block: the pipeline takes "
                                   "the 7x7/s2 conv, BN, ReLU stem")
    pool = getattr(ib, "pool", None)
    if not isinstance(pool, nn.MaxPool2d) or pool.kernel_size not in (
            3, (3, 3)) or pool.stride not in (2, (2, 2)) or \
            pool.padding not in (1, (1, 1)):
        raise UnsupportedTreeError("features/init_block: the pipeline takes "
                                   "a 3x3/s2 pad-1 max-pool")
    stages = sorted((n for n in _param_children(f) if n.startswith("stage")),
                    key=lambda s: int(s[5:]))
    with torch.no_grad():
        g0, b0 = _bn_affine(ib.bn, fused=False)
        kf = ib.conv.weight.detach().to(torch.bfloat16).permute(1, 2, 3, 0)
        plan = {"stem": {"kf": kf.contiguous(), "g": g0, "b": b0},
                "units": []}
        for sname in stages:
            stage = getattr(f, sname)
            for uname in sorted(_param_children(stage),
                                key=lambda u: int(u[4:])):
                plan["units"].append(_unit_plan(
                    getattr(stage, uname), f"features/{sname}/{uname}",
                    scales.__getitem__))
        plan["post_activ"] = _bn_affine(f.post_activ.bn)
        plan["head"] = _head_plan(model.output.weight, model.output.bias)
    return _forward, plan

