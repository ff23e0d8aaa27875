"""Serving entry point: raw uint8 frames -> predictions.

    serve = make_serving_fn("resnet50", source_hw=(256, 256))
    logits = serve(batch_u8)        # (B, 256, 256, 3) uint8 -> (B, 1000) bf16

    serve = make_serving_fn("wrn50_2", (256, 256))   # the same int8 route

    serve = make_serving_fn("pspnet_resnetd101b_voc", (375, 500),
                            task="segmentation")
    maps = serve(batch_u8)          # -> 2 x (B, 21, 480, 480) bf16 (aux)

    serve = make_serving_fn("simplepose_resnet50b_coco", (320, 240),
                            task="pose")
    keypoints = serve(batch_u8)     # -> (B, 17, 3) bf16 (x, y, score)

    serve = make_serving_fn("centernet_resnet50b_coco", (480, 640),
                            task="detection")
    boxes = serve(batch_u8)         # -> (B, 40, 6) f32

    serve = make_serving_fn("efficientnet_b0", (256, 256))   # bf16 route

    serve = make_serving_fn("mobilenetv2_w1", (256, 256))    # int8 route

Six routes of the JAX package's ``make_serving_fn``, all on the card by
default:

* ``resnet`` (classification): the eval preprocess (kernel K1, planar bf16
  out), calibration in the preprocessed domain, and the int8 ResNet
  pipeline (kernels K3, ``maxpool_i8``, K2 and the K8 bottleneck chains),
  for ResNets and the BN-less WRN;
* ``mobilenetv2`` and ``mobilenet_v1`` (classification): the same
  preprocess and calibration, and the int8 MobileNet pipelines (K3, the
  int8 depthwise conv K12, K2);
* ``seg_backbone`` (segmentation: PSPNet, DeepLabv3, FCN-8s(d), DANet): the
  resize-only preprocess (K1), calibration over the whole f32 model, the
  int8 dilated backbone (K3, ``maxpool_i8``, K2; the stage-3 bend written
  in K2's launch where the head reads it) and the model's own head on a
  bf16 copy, fed through ``from_features=True`` (DANet's position
  attention on K4);
* ``plain_trunk`` (pose: SimplePose and AlphaPose; detection: CenterNet):
  the resize-only preprocess (K1), calibration, the int8 plain ResNet
  trunk (K3 7x7, ``maxpool_i8``, K2; AlphaPose's SE units on K11) and the
  bf16 head and decode, fed through ``from_features=True``;

  each of these five runs only for a model whose tree passes its
  pipeline's check (``quant.is_plain_resnet_tree``, the JAX package's
  ``_is_plain_resnet``; ``quant.mobilenet_int8``'s;
  ``quant.is_seg_resnetd_backbone`` and ``quant.is_plain_resnet_trunk``,
  with a head whose forward takes ``from_features``); in ``mode="auto"`` a
  model that fails it (``mobilenetb_*``: no BN on its depthwise convs; a
  ResNet unit with another branch) is served in bf16, as in the JAX
  package;
* bf16 (every task): the task's preprocess (K1, planar bf16 out) and a
  bf16 copy of the model (``as_bfloat16``), for ``mode="bf16"`` and for a
  family that declares no int8 route in ``mode="auto"`` (EfficientNet and
  MobileNetV3, whose depthwise blocks run K6; Fast-SE-ResNet).
"""

from __future__ import annotations

import copy
import inspect
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
from .quant import (calibrate_int8, is_mobilenet_v1_tree,
                    is_mobilenet_v2_tree, is_plain_resnet_tree,
                    is_plain_resnet_trunk, is_seg_resnetd_backbone,
                    prepare_int8_mobilenet, prepare_int8_mobilenet_v1,
                    prepare_int8_plain_trunk, prepare_int8_resnet,
                    prepare_int8_seg_backbone)

__all__ = ["make_serving_fn", "declared_int8_route"]

# The int8 pipeline each model family (the constructor's module) may use,
# copied from the JAX package's table (serve.py:43-69), where every entry
# rests on an A/B measurement; a trailing '!' marks pipelines used only when
# the caller forces mode='int8'. The port has the "resnet",
# "seg_backbone", "plain_trunk", "mobilenet_v1" and "mobilenetv2"
# pipelines; the others raise NotImplementedError.
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
_TASK_ROUTES = {"classification": ("resnet", "mobilenet_v1", "mobilenetv2"),
                "segmentation": ("seg_backbone",),
                "pose": ("plain_trunk",), "detection": ("plain_trunk",)}


def _takes_features(model: nn.Module) -> bool:
    """Whether the model's forward takes ``from_features``: a head the
    dense pipelines can feed (JAX ``serve.py:242-243``)."""
    return "from_features" in inspect.signature(type(model).forward).parameters


# Each pipeline's check of the tree and its prepare.
_ROUTES = {
    "resnet": (is_plain_resnet_tree, prepare_int8_resnet),
    "mobilenet_v1": (is_mobilenet_v1_tree, prepare_int8_mobilenet_v1),
    "mobilenetv2": (is_mobilenet_v2_tree, prepare_int8_mobilenet),
    "seg_backbone": (lambda m: _takes_features(m) and
                     is_seg_resnetd_backbone(m), prepare_int8_seg_backbone),
    "plain_trunk": (lambda m: _takes_features(m) and is_plain_resnet_trunk(m),
                    prepare_int8_plain_trunk)}


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


def as_bfloat16(model: nn.Module,
                without: Optional[nn.Module] = None) -> nn.Module:
    """A bf16 copy for inference (JAX ``Model.as_bfloat16``): parameters are
    rounded to bf16; BN statistics stay f32, and BN's own scale and shift
    keep f32 storage of their bf16-rounded values (PyTorch's BN takes a
    bf16 input only beside f32 parameters). ``without``: a submodule left
    out of the copy (None in its place; the head of a dense pipeline needs
    no copy of the backbone it replaces)."""
    memo = {} if without is None else {id(without): None}
    bf = copy.deepcopy(model, memo)
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
    ``task="segmentation"``: bf16 class maps (B, classes, H, W) at the
    model's ``in_size``, with ``aux`` also the aux maps (one for PSPNet,
    DeepLabv3 and FCN-8s(d), two for DANet).
    ``task="pose"``: keypoints (B, K, 3) of (x, y, score) in bf16 on the
    heatmap's grid (the heatmaps with the model's ``return_heatmap``).
    ``task="detection"``: CenterNet's boxes (B, topk, 6) f32 (the pre-decode
    tensor with ``return_heatmap``). Segmentation, pose and detection
    resize straight to the model's ``in_size``.
    ``mode``: 'auto' serves the family's declared int8 pipeline (the
    measured choice), or bf16 where the family declares none in auto;
    'int8' forces the int8 pipeline; 'bf16' forces bf16. A tree that fails
    its int8 pipeline's check is served in bf16 in 'auto' and raises
    ``NotImplementedError`` in 'int8' (the generic int8 interception is not
    ported). Pipelines, families and tasks not yet ported raise
    ``NotImplementedError``.
    ``calib_batches``: preprocessed NCHW f32 batches for calibration.
    ``model``: a built module on ``device`` to serve instead of a fresh
    ``get_model(model_name, device=device, **model_kwargs)``. The closure
    carries ``route`` ("bf16" or the int8 pipeline's name);
    ``make_reference_forward()``, the f32 oracle: f32 preprocess and the
    unquantized f32 model, without TF32 and with its depthwise blocks
    unfused (no K6 in it); ``head``, the bf16 copy of the model without
    its backbone that a dense int8 pipeline feeds (None otherwise); and
    ``scales``, the calibrated amaxes of an int8 route (None on the bf16
    route)."""
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
    elif route not in _TASK_ROUTES[task]:
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
    if route is not None and not _ROUTES[route][0](model):
        if mode == "int8":
            raise NotImplementedError(
                f"{model_name!r}: the tree fails the {route!r} pipeline's "
                f"check; the generic int8 interception is not yet ported")
        route = None

    if task == "classification":
        def make_pre(**kw):
            return classification_preprocess(
                model_name, source_hw, model_in_size=model.in_size,
                layout="nchw", device=device, **kw)
    else:
        def make_pre(**kw):
            return segmentation_preprocess(tuple(model.in_size), source_hw,
                                           layout="nchw", device=device,
                                           **kw)

    pre = make_pre()
    head = scales = None
    if route is None:
        infer = as_bfloat16(model)
    else:
        scales = _calibrate(model, calib_batches, pre, source_hw, device)
        run, plan = _ROUTES[route][1](model, scales)
        if task == "classification":
            def infer(x):
                return run(plan, x)
        else:
            head = as_bfloat16(model, without=model.backbone)

            def nchw(t):
                return None if t is None else t.permute(0, 3, 1, 2)

            def infer(x):
                outs = run(plan, x)
                feats = tuple(map(nchw, outs)) if isinstance(outs, tuple) \
                    else nchw(outs)
                return head(feats, from_features=True)

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
