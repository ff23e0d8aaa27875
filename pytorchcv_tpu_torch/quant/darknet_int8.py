"""int8 DarkNet-53 serving pipeline (counterpart of
``pytorchcv_tpu.quant.darknet_int8``).

Activations are stored int8 NHWC between layers; weights are quantized
once per output channel and BN folded into a per-channel gain and bias
(JAX ``resnet_int8._cell_consts``, run eagerly by JAX
``prepare_int8_darknet``: ``s_w`` a true division by 127, the bias ``beta -
mean * g`` two roundings); every scalar derived from the calibrated scales
is derived once with the JAX pipeline's float32 roundings, so the int8 maps
match its maps bit for bit on the same weights and scales (the stem's f32
sums aside: K3 adds its products in another order). The leaky ReLU is
``max(y, 0) + 0.1 min(y, 0)``, two roundings (JAX ``_leaky``):

* init block: the folded bf16 3x3 kernel at stride 1 on K3, + bias, leaky,
  quant (JAX ``_forward`` :92-97; its fold's ``1e-5`` is the BN epsilon);
* each stage's 3x3/s2 downsample conv and each DarkUnit's 1x1 conv1: K2
  with the leaky act and requant (JAX ``_cell_lk``);
* each DarkUnit's 3x3 conv2: K2's act-then-residual epilogue, ``leaky(acc
  * A + B) + f32(x) * (s_in / 127)`` in f32 with x the unit's int8 input,
  requantized to the next conv's scale, or f32 after the last unit;
* head: the mean over H and W and the dense layer in f32 (its kernel
  rounded to bf16 as JAX stores it).

Strides are read from the model. ``is_darknet53_tree`` is JAX
``is_darknet53_tree``'s check on the module tree; ``make_serving_fn``
serves a tree that fails it in bf16.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels._build import f32 as _f32
from ..kernels.int8_conv import int8_conv
from ..kernels.stem import stem_conv
from .mobilenet_int8 import _head, _head_plan
from .resnet_int8 import (_EPS, UnsupportedTreeError, _param_children,
                          _planar_bf16)
from .vgg_int8 import quantize_eager

__all__ = ["is_darknet53_tree", "prepare_int8_darknet"]

_ALPHA = 0.1


def is_darknet53_tree(model: nn.Module) -> bool:
    """True for the zoo DarkNet-53 layout (JAX ``is_darknet53_tree``): an
    ``init_block`` of {conv, bn}, stages whose unit1 is a {conv, bn}
    downsample and whose other units are {conv1 (1x1), conv2 (3x3)}, a
    dense ``output``."""
    f = getattr(model, "features", None)
    if not isinstance(f, nn.Module):
        return False
    names = _param_children(f)
    ib = getattr(f, "init_block", None)
    if ib is None or _param_children(ib) != {"conv", "bn"} or \
            getattr(ib.conv, "weight", None) is None or \
            ib.conv.weight.dim() != 4:
        return False
    stages = {n for n in names if n.startswith("stage")}
    if not stages or names != stages | {"init_block"}:
        return False
    for sname in stages:
        stage = getattr(f, sname)
        units = _param_children(stage)
        if "unit1" not in units or \
                _param_children(stage.unit1) != {"conv", "bn"}:
            return False
        for uname in units - {"unit1"}:
            unit = getattr(stage, uname)
            if _param_children(unit) != {"conv1", "conv2"}:
                return False
            for conv, k in ((unit.conv1, 1), (unit.conv2, 3)):
                w = getattr(getattr(conv, "conv", None), "weight", None)
                if w is None or tuple(w.shape[2:]) != (k, k):
                    return False
    out = getattr(model, "output", None)
    w = getattr(out, "weight", None)
    return w is not None and w.dim() == 2


def _cell_consts(block: nn.Module, path: str) -> Dict:
    """Fold a conv + BN block into {wq int8 (Cout, k, k, Cin), gain, bias,
    stride} as JAX's eager ``resnet_int8._cell_consts`` rounds it."""
    conv, bn = block.conv, getattr(block, "bn", None)
    act = getattr(block, "activ", None)
    if bn is None or not isinstance(act, nn.LeakyReLU) or \
            act.negative_slope != _ALPHA or conv.groups != 1 or \
            conv.dilation != (1, 1) or \
            conv.padding != (conv.kernel_size[0] // 2,) * 2:
        raise UnsupportedTreeError(f"{path}: the pipeline takes conv + BN + "
                                   f"leaky ReLU ({_ALPHA}) blocks, pad k // 2")
    kernel = conv.weight.detach().to(torch.float32).permute(0, 2, 3, 1)
    wq, s_w = quantize_eager(kernel, (1, 2, 3))
    g = bn.weight.detach().to(torch.float32) * torch.rsqrt(
        bn.running_var.to(torch.float32) + _EPS)
    bias = bn.bias.detach().to(torch.float32) - \
        bn.running_mean.to(torch.float32) * g
    return {"wq": wq, "gain": s_w * g, "bias": bias, "g": g,
            "stride": conv.stride[0]}


def _k2_step(cell: Dict, s_in: float, s_out: Optional[float]) -> Dict:
    """A K2 call's operands with the leaky act: A = gain * f32(s_in / 127),
    B = bias, q = f32(127 / s_out) (None: f32 output)."""
    return {"w": cell["wq"], "a": cell["gain"] * _f32(s_in / 127.0),
            "b": cell["bias"], "stride": cell["stride"],
            "q": None if s_out is None else _f32(127.0 / s_out)}


def _k2(step: Dict, x: torch.Tensor, **tail) -> torch.Tensor:
    return int8_conv(x, step["w"], step["a"], step["b"],
                     stride=step["stride"], act="leaky", q=step["q"],
                     out_f32=step["q"] is None, **tail)


def _forward(plan: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x``: planar (B, 3, H, W) or NHWC (B, H, W, 3) model input -> bf16
    logits (B, classes)."""
    st = plan["stem"]
    y = stem_conv(_planar_bf16(x), st["kf"], st["bias"], st["q"], "leaky",
                  stride=1)
    for u in plan["units"]:
        if "down" in u:
            y = _k2(u["down"], y)
        else:
            t = _k2(u["conv1"], y)
            y = _k2(u["conv2"], t, residual=y, res_scale=u["res_scale"],
                    res_after_act=True)
    return _head(plan["head"], y.mean(dim=(1, 2)))


def prepare_int8_darknet(model: nn.Module, scales: Dict[str, float]
                         ) -> Tuple[Callable, Dict]:
    """Serving entry point: quantize weights once and return ``(infer_fn,
    plan)`` with ``infer_fn(plan, x) -> bf16 logits``. ``scales``: {path:
    amax} from ``calibrate_int8`` (or the JAX package's)."""
    if not is_darknet53_tree(model):
        raise UnsupportedTreeError("not a DarkNet-53 tree")
    f = model.features
    order = []
    for sname in sorted(_param_children(f) - {"init_block"},
                        key=lambda s: int(s[5:])):
        stage = getattr(f, sname)
        order += [(f"features/{sname}/{u}", getattr(stage, u)) for u in
                  sorted(_param_children(stage), key=lambda u: int(u[4:]))]

    def s_of(prefix, unit):
        leaf = "conv" if hasattr(unit, "bn") else "conv1/conv"
        return scales[f"{prefix}/{leaf}"]

    with torch.no_grad():
        ib = _cell_consts(f.init_block, "features/init_block")
        if ib["stride"] != 1:
            raise UnsupportedTreeError("features/init_block: the pipeline "
                                       "takes a stride-1 stem")
        kernel = f.init_block.conv.weight.detach().to(torch.float32)
        kf = (kernel * ib["g"][:, None, None, None]).to(torch.bfloat16)
        s_in = s_of(*order[0])
        plan = {"stem": {"kf": kf.permute(1, 2, 3, 0).contiguous(),
                         "bias": ib["bias"], "q": _f32(127.0 / s_in)},
                "units": []}
        for i, (prefix, unit) in enumerate(order):
            s_next = s_of(*order[i + 1]) if i + 1 < len(order) else None
            if hasattr(unit, "bn"):
                plan["units"].append({"down": _k2_step(
                    _cell_consts(unit, prefix), s_in, s_next)})
            else:
                c1 = _cell_consts(unit.conv1, f"{prefix}/conv1")
                c2 = _cell_consts(unit.conv2, f"{prefix}/conv2")
                if c1["stride"] != 1 or c2["stride"] != 1:
                    raise UnsupportedTreeError(f"{prefix}: a residual unit "
                                               f"with a stride")
                s_mid = scales[f"{prefix}/conv2/conv"]
                plan["units"].append({
                    "conv1": _k2_step(c1, s_in, s_mid),
                    "conv2": _k2_step(c2, s_mid, s_next),
                    "res_scale": _f32(s_in / 127.0)})
            s_in = s_next
        plan["head"] = _head_plan(model.output.weight, model.output.bias)
    return _forward, plan
