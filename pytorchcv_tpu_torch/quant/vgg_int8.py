"""int8 VGG serving pipeline (counterpart of
``pytorchcv_tpu.quant.vgg_int8``), for all 12 VGG variants: bias, BN, and
BN with bias.

Activations are stored int8 NHWC between layers; weights are quantized
once per output channel and the conv bias and BN folded into a per-channel
gain and bias (JAX ``_conv_consts``, which runs eagerly: ``s_w`` is a true
division by 127, the bias ``beta + g * (bias - mean)`` three roundings);
every scalar derived from the calibrated scales is derived once with the
JAX pipeline's float32 roundings, so the int8 maps match its maps bit for
bit on the same weights and scales (the stem's f32 sums aside: K3 adds its
products in another order):

* conv1_1: the folded bf16 3x3 kernel at stride 1 on K3, + bias, ReLU,
  quant to the next conv's scale;
* every other conv: K2 with ReLU and requant (JAX ``_cell``);
* each stage's end: the 2x2/s2 int8 max-pool (``maxpool_i8(..., 2)``);
* the head: fc1, fc2 and fc3 on K2 as 1x1 convs over the (B, 1, 1, K)
  map (JAX ``_fc_i8``): ReLU and requant for fc1 and fc2, fc3 without
  activation written as bf16 (K2's bf16 output: the f32 value rounded
  once, as JAX's f32 logits cast to bf16). JAX flattens the last map in
  NCHW order; here fc1's K rows are permuted once, at prepare, to the
  NHWC order in which the int8 map lies, so K2 reads it as it is (int32
  sums are exact: the same logits).

``is_plain_vgg`` is JAX ``is_plain_vgg``'s check on the module tree;
``make_serving_fn`` serves a tree that fails it in bf16.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from ..kernels._build import f32 as _f32
from ..kernels.int8_conv import int8_conv
from ..kernels.stem import maxpool_i8, stem_conv
from .mobilenet_int8 import _k2_step
from .resnet_int8 import (_EPS, UnsupportedTreeError, _param_children,
                          _planar_bf16)

__all__ = ["is_plain_vgg", "prepare_int8_vgg"]


def is_plain_vgg(model: nn.Module) -> bool:
    """True when ``model`` has the zoo VGG layout the pipeline serves,
    decided as JAX ``is_plain_vgg`` decides on the parameter tree:
    ``features`` holds only stages of ``unitN`` blocks of a 3x3 ``conv``
    (and ``bn``), ``output`` holds ``fc1`` and ``fc2`` wrapping an ``fc``
    and a bare ``fc3``."""
    f, out = getattr(model, "features", None), getattr(model, "output", None)
    if not isinstance(f, nn.Module) or not isinstance(out, nn.Module):
        return False
    names = _param_children(f)
    stages = {n for n in names if n.startswith("stage")}
    if not stages or names != stages:
        return False
    for sname in stages:
        stage = getattr(f, sname)
        units = _param_children(stage)
        if not units or any(not u.startswith("unit") for u in units):
            return False
        for uname in units:
            unit = getattr(stage, uname)
            branches = _param_children(unit)
            if branches - {"conv", "bn"} or "conv" not in branches:
                return False
            w = getattr(unit.conv, "weight", None)
            if w is None or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
                return False
    if _param_children(out) != {"fc1", "fc2", "fc3"}:
        return False
    for name in ("fc1", "fc2"):
        if getattr(getattr(getattr(out, name), "fc", None), "weight",
                   None) is None:
            return False
    return getattr(out.fc3, "weight", None) is not None


def div_f32(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device (PyTorch's CUDA division
    by a Python scalar multiplies by the reciprocal; by a 0-dim tensor it
    divides), as JAX's eager ``x / d`` rounds."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_eager(kernel: torch.Tensor, dims) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """``(wq int8, s_w)``: per-output-channel symmetric int8 weights, the
    abs-max over ``dims`` divided by 127 (JAX's eager ``_conv_consts`` /
    ``_fc_consts`` / ``resnet_int8._cell_consts``)."""
    s_w = div_f32(torch.clamp_min(kernel.abs().amax(dim=dims), 1e-12), 127.0)
    shape = [-1] + [1] * (kernel.dim() - 1)
    wq = torch.clamp(torch.round(kernel / s_w.reshape(shape)), -127, 127)
    return wq.to(torch.int8).contiguous(), s_w


def _conv_consts(unit: nn.Module, path: str) -> Tuple[Dict, torch.Tensor]:
    """Fold conv (+ bias) (+ BN) into {wq (Cout, 3, 3, Cin), gain, bias}
    and the folded bf16 kernel (3, 3, 3, Cout) of a first conv (JAX
    ``_conv_consts``)."""
    conv, bn = unit.conv, getattr(unit, "bn", None)
    if conv.stride != (1, 1) or conv.padding != (1, 1) or \
            conv.dilation != (1, 1) or conv.groups != 1 or \
            not isinstance(getattr(unit, "activ", None), nn.ReLU):
        raise UnsupportedTreeError(f"{path}: the pipeline takes 3x3 stride-1 "
                                   f"pad-1 convs with ReLU")
    kernel = conv.weight.detach().to(torch.float32).permute(0, 2, 3, 1)
    cbias = torch.zeros(kernel.shape[0], device=kernel.device) \
        if conv.bias is None else conv.bias.detach().to(torch.float32)
    if bn is not None:
        g = bn.weight.detach().to(torch.float32) * torch.rsqrt(
            bn.running_var.to(torch.float32) + _EPS)
        bias = bn.bias.detach().to(torch.float32) + g * (
            cbias - bn.running_mean.to(torch.float32))
    else:
        g, bias = torch.ones_like(cbias), cbias
    wq, s_w = quantize_eager(kernel, (1, 2, 3))
    kf = (kernel * g[:, None, None, None]).to(torch.bfloat16)
    return {"wq": wq, "gain": s_w * g, "bias": bias}, \
        kf.permute(3, 1, 2, 0).contiguous()


def _k2(step: Dict, x: torch.Tensor) -> torch.Tensor:
    """A K2 call of ``_k2_step``'s operands at stride 1; no ``q``: bf16
    output."""
    return int8_conv(x, step["w"], step["a"], step["b"], stride=1,
                     act=step["act"], q=step["q"])


def _fc_cell(fc: nn.Linear, hw: Tuple[int, int] = (1, 1)) -> Dict:
    """A dense layer as a 1x1 conv: {wq (O, 1, 1, K), gain = s_w, bias}
    (JAX ``_fc_consts``), K reordered from NCHW order over an ``hw`` map
    to NHWC order."""
    w = fc.weight.detach().to(torch.float32)
    wq, s_w = quantize_eager(w, (1,))
    o, k = wq.shape
    c = k // (hw[0] * hw[1])
    wq = wq.reshape(o, c, *hw).permute(0, 2, 3, 1).reshape(o, 1, 1, k)
    return {"wq": wq.contiguous(), "gain": s_w,
            "bias": fc.bias.detach().to(torch.float32)}


def _forward(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x``: planar (B, 3, H, W) or NHWC (B, H, W, 3) model input -> bf16
    logits (B, classes)."""
    st = plan["stem"]
    xq = stem_conv(_planar_bf16(x), st["kf"], st["bias"], st["q"], "relu",
                   stride=1)
    for step in plan["convs"]:
        if step["pool"]:
            xq = maxpool_i8(xq, 2)
        xq = _k2(step, xq)
    h = maxpool_i8(xq, 2)
    h = h.reshape(h.shape[0], 1, 1, -1)
    for step in plan["fc"]:
        h = _k2(step, h)
    return h.reshape(h.shape[0], -1)


def prepare_int8_vgg(model: nn.Module, scales: Dict[str, float]
                     ) -> Tuple[Callable, Dict]:
    """Serving entry point: quantize weights once and return ``(infer_fn,
    plan)`` with ``infer_fn(plan, x) -> bf16 logits``. ``scales``: {path:
    amax} from ``calibrate_int8`` (or the JAX package's)."""
    if not is_plain_vgg(model):
        raise UnsupportedTreeError("not a plain VGG tree")
    f = model.features
    stages = sorted(_param_children(f), key=lambda s: int(s[5:]))
    order = []
    for sname in stages:
        stage = getattr(f, sname)
        pool = getattr(stage, "pool", None)
        if not isinstance(pool, nn.MaxPool2d) or pool.kernel_size not in (
                2, (2, 2)) or pool.stride not in (2, (2, 2)) or \
                pool.padding not in (0, (0, 0)):
            raise UnsupportedTreeError(f"features/{sname}: the pipeline "
                                       f"takes a 2x2/s2 pool at its end")
        units = sorted(_param_children(stage), key=lambda u: int(u[4:]))
        order += [(sname, u, getattr(stage, u)) for u in units]
    s_list = [scales[f"features/{s}/{u}/conv"] for s, u, _ in order]
    s_list.append(scales["output/fc1/fc"])
    out = model.output
    hw = (model.in_size[0] // 32, model.in_size[1] // 32)
    if out.fc1.fc.in_features != order[-1][2].conv.out_channels * \
            hw[0] * hw[1]:
        raise UnsupportedTreeError(f"output/fc1 takes {out.fc1.fc.in_features}"
                                   f" features, not the last map's "
                                   f"{hw} x {order[-1][2].conv.out_channels}")
    with torch.no_grad():
        cells = [_conv_consts(unit, f"features/{s}/{u}")
                 for s, u, unit in order]
        first, kf = cells[0]
        plan = {"stem": {"kf": kf, "bias": first["bias"],
                         "q": _f32(127.0 / s_list[1])}, "convs": []}
        for i in range(1, len(order)):
            step = _k2_step(cells[i][0], s_list[i], s_list[i + 1], "relu")
            step["pool"] = order[i][0] != order[i - 1][0]
            plan["convs"].append(step)
        s_fc2, s_fc3 = scales["output/fc2/fc"], scales["output/fc3"]
        plan["fc"] = [
            _k2_step(_fc_cell(out.fc1.fc, hw), s_list[-1], s_fc2, "relu"),
            _k2_step(_fc_cell(out.fc2.fc), s_fc2, s_fc3, "relu"),
            _k2_step(_fc_cell(out.fc3), s_fc3, None)]
    return _forward, plan
