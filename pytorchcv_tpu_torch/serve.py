"""Serving entry point: raw uint8 frames -> predictions.

    serve = make_serving_fn("resnet50", source_hw=(256, 256))
    logits = serve(batch_u8)        # (B, 256, 256, 3) uint8 -> (B, 1000) bf16

    serve = make_serving_fn("wrn50_2", (256, 256))   # the same int8 route

    serve = make_serving_fn("danet_resnetd50b_cityscapes", (1024, 2048),
                            task="segmentation")
    maps = serve(batch_u8)          # -> 3 x (B, 19, 480, 480) bf16 (aux)

    serve = make_serving_fn("efficientnet_b0", (256, 256))   # bf16 route

Three routes of the JAX package's ``make_serving_fn``, all on the card by
default:

* ``resnet`` (classification): the eval preprocess (kernel K1, planar bf16
  out), calibration in the preprocessed domain, and the int8 ResNet
  pipeline (kernels K3, ``maxpool_i8``, K2 and the K8 bottleneck chains),
  for ResNets and the BN-less WRN;
* ``seg_backbone`` (segmentation): the resize-only preprocess (K1),
  calibration over the whole f32 model, the int8 dilated backbone (K3,
  ``maxpool_i8``, K2) and the model's own head on a bf16 copy, fed through
  ``from_features=True`` (DANet's position attention on K4);
* bf16 (classification): the eval preprocess (K1, planar bf16 out) and a
  bf16 copy of the model (``as_bfloat16``), for ``mode="bf16"`` and for a
  family that declares no int8 route in ``mode="auto"`` (EfficientNet,
  whose depthwise blocks run K6).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .kernels._build import no_tf32
from .kernels.preprocess import (classification_preprocess,
                                 segmentation_preprocess)
from .model_provider import get_model, resolve_device
from .models.registry import get_constructor
from .nn.conv import unfused_depthwise
from .quant import (calibrate_int8, is_seg_resnetd_backbone,
                    prepare_int8_resnet, prepare_int8_seg_backbone)

__all__ = ["make_serving_fn", "declared_int8_route"]

# The int8 pipeline each model family (the constructor's module) may use,
# copied from the JAX package's table (serve.py:43-69), where every entry
# rests on an A/B measurement; a trailing '!' marks pipelines used only when
# the caller forces mode='int8'. The port has the "resnet" and
# "seg_backbone" pipelines; the others raise NotImplementedError.
_INT8_ROUTES = {
    "resnet": "resnet", "seresnet": "resnet", "resnext": "resnet",
    "seresnext": "resnet", "senet": "resnet", "wrn": "resnet",
    "resnet_cifar": "resnet", "seresnet_cifar": "resnet",
    "resnext_cifar": "resnet", "wrn_cifar": "resnet",
    "preresnet": "preresnet", "sepreresnet": "preresnet",
    "preresnet_cifar": "preresnet", "sepreresnet_cifar": "preresnet",
    "mobilenet": "mobilenet_v1", "mobilenetv2": "mobilenetv2",
    "vgg": "vgg", "darknet53": "darknet",
    "pspnet": "seg_backbone", "deeplabv3": "seg_backbone",
    "fcn8sd": "seg_backbone", "danet": "seg_backbone",
    "simplepose_coco": "plain_trunk", "alphapose_coco": "plain_trunk",
    "centernet": "plain_trunk",
    "mobilenetv3": "mobilenetv3!", "efficientnet": "efficientnet!",
}
_TASK_ROUTES = {"classification": "resnet", "segmentation": "seg_backbone"}


def declared_int8_route(model_name: str, mode: str = "auto") -> Optional[str]:
    """The int8 pipeline declared for ``model_name``'s family, or None.
    ``mode='int8'`` also unlocks the '!'-suffixed pipelines."""
    module = get_constructor(model_name).__module__.rsplit(".", 1)[-1]
    route = _INT8_ROUTES.get(module)
    if route is None:
        return None
    if route.endswith("!"):
        return route[:-1] if mode == "int8" else None
    return route


def _as_input(raw, device) -> torch.Tensor:
    if isinstance(raw, np.ndarray):
        raw = torch.from_numpy(raw)
    return raw.to(device)


def _calibrate(model: nn.Module, calib_batches: Optional[Sequence], pre,
               source_hw: Tuple[int, int], device) -> dict:
    """Calibrate in the preprocessed input domain. By default, 8 random
    uint8 frames (seed 0) go through the serving preprocess (bf16, as
    served) and are cast to f32."""
    if calib_batches is None:
        g = torch.Generator().manual_seed(0)
        raw = torch.randint(0, 256, (8, *source_hw, model.in_channels),
                            generator=g, dtype=torch.uint8)
        calib_batches = [pre(raw.to(device)).to(torch.float32)]
    with no_tf32():
        return calibrate_int8(model, calib_batches)


def as_bfloat16(model: nn.Module) -> nn.Module:
    """A bf16 copy for inference (JAX ``Model.as_bfloat16``): parameters are
    rounded to bf16; BN statistics stay f32, and BN's own scale and shift
    keep f32 storage of their bf16-rounded values (PyTorch's BN takes a
    bf16 input only beside f32 parameters)."""
    bf = copy.deepcopy(model)
    with torch.no_grad():
        for m in bf.modules():
            if isinstance(m, nn.BatchNorm2d):
                for p in (m.weight, m.bias):
                    p.copy_(p.to(torch.bfloat16).to(torch.float32))
            else:
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(torch.bfloat16)
    return bf


def make_serving_fn(model_name: str, source_hw: Tuple[int, int],
                    mode: str = "auto", task: str = "classification",
                    calib_batches: Optional[Sequence] = None, device=None,
                    model: Optional[nn.Module] = None,
                    **model_kwargs) -> Callable:
    """Build a ``uint8 (B, H, W, 3) -> prediction`` closure on ``device``
    (default: the CUDA card; ``"cpu"`` must be asked for).

    ``task="classification"``: bf16 logits (B, classes).
    ``task="segmentation"`` (DANet): bf16 class maps (B, classes, H, W) at
    the model's ``in_size``, three of them with ``aux``.
    ``mode``: 'auto' serves the family's declared int8 pipeline (the
    measured choice), or bf16 where the family declares none in auto;
    'int8' forces the int8 pipeline; 'bf16' forces bf16 (classification
    only). Pipelines, families and tasks not yet ported raise
    ``NotImplementedError``. ``calib_batches``: preprocessed NCHW f32
    batches for calibration. ``model``: a built module on ``device`` to
    serve instead of a fresh ``get_model(model_name, device=device,
    **model_kwargs)``. The closure carries ``route`` ("bf16" or the int8
    pipeline's name); ``make_reference_forward()``, the f32 oracle: f32
    preprocess and the unquantized f32 model, without TF32 and with its
    depthwise blocks unfused (no K6 in it); ``head``, the bf16 copy of the
    model that runs the segmentation head (None otherwise); and ``scales``,
    the calibrated amaxes of an int8 route (None on the bf16 route)."""
    if task not in _TASK_ROUTES:
        raise NotImplementedError(f"task {task!r} is not yet ported")
    if mode not in ("auto", "int8", "bf16"):
        raise NotImplementedError(f"mode {mode!r} is not yet ported")
    route = None if mode == "bf16" else declared_int8_route(model_name, mode)
    if route is None:
        if mode == "int8":
            raise NotImplementedError(
                f"{model_name!r}: no int8 pipeline is declared; the generic "
                f"int8 interception is not yet ported")
        if task != "classification":
            raise NotImplementedError(
                f"task {task!r} in bf16 is not yet ported")
    elif route != _TASK_ROUTES[task]:
        raise NotImplementedError(
            f"{model_name!r}, task {task!r}: int8 route {route!r} is not "
            f"ported (ported: {_TASK_ROUTES[task]!r})")
    device = resolve_device(device)
    if model is None:
        model = get_model(model_name, device=device, **model_kwargs)
    own = next(model.parameters()).device
    if own.type != device.type:
        raise ValueError(f"model is on {own}, the serving device is {device}")
    device = own

    if task == "classification":
        def make_pre(**kw):
            return classification_preprocess(
                model_name, source_hw, model_in_size=model.in_size,
                layout="nchw", device=device, **kw)
    else:
        if not (is_seg_resnetd_backbone(model) and hasattr(model, "head")):
            raise NotImplementedError(
                f"{model_name!r}: only a ResNet(D)-b backbone under a "
                f"from_features head is ported")

        def make_pre(**kw):
            return segmentation_preprocess(tuple(model.in_size), source_hw,
                                           layout="nchw", device=device,
                                           **kw)

    pre = make_pre()
    head = scales = None
    if route is None:
        infer = as_bfloat16(model)
    elif task == "classification":
        scales = _calibrate(model, calib_batches, pre, source_hw, device)
        run, plan = prepare_int8_resnet(model, scales)

        def infer(x):
            return run(plan, x)
    else:
        scales = _calibrate(model, calib_batches, pre, source_hw, device)
        backbone, plan = prepare_int8_seg_backbone(
            model, scales, bend=getattr(model, "reads_bend", True))
        head = as_bfloat16(model)
        head.backbone = None

        def infer(x):
            outs = backbone(plan, x)
            return head(tuple(None if o is None else o.permute(0, 3, 1, 2)
                              for o in outs), from_features=True)

    def pipeline(raw_u8):
        with torch.inference_mode():
            return infer(pre(_as_input(raw_u8, device)))

    def make_reference_forward() -> Callable:
        pre32 = make_pre(out_dtype=torch.float32)

        def reference(raw_u8):
            with torch.inference_mode(), no_tf32(), unfused_depthwise(model):
                return model(pre32(_as_input(raw_u8, device)))

        return reference

    pipeline.route = "bf16" if route is None else route
    pipeline.make_reference_forward = make_reference_forward
    pipeline.head = head
    pipeline.scales = scales
    return pipeline
