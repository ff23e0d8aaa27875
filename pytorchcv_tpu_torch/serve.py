"""Serving entry point: raw uint8 frames -> logits.

    serve = make_serving_fn("resnet50", source_hw=(256, 256), device="cuda")
    logits = serve(batch_u8)        # (B, 256, 256, 3) uint8 -> (B, 1000) bf16

The ``resnet`` route of the JAX package's ``make_serving_fn``: the eval
preprocess (kernel K1, planar bf16 out), calibration in the preprocessed
domain, and the int8 ResNet pipeline (kernels K3 and K2).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .kernels._build import no_tf32
from .kernels.preprocess import classification_preprocess
from .model_provider import get_model
from .models.registry import get_constructor
from .quant import calibrate_int8, prepare_int8_resnet

__all__ = ["make_serving_fn"]


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


def make_serving_fn(model_name: str, source_hw: Tuple[int, int],
                    mode: str = "auto", task: str = "classification",
                    calib_batches: Optional[Sequence] = None, device=None,
                    model: Optional[nn.Module] = None,
                    **model_kwargs) -> Callable:
    """Build a ``uint8 (B, H, W, 3) -> bf16 logits (B, classes)`` closure
    for a ResNet on ``device`` (default: the CPU).

    ``mode``: 'auto' and 'int8' both serve the int8 pipeline (the measured
    choice for ResNets); other modes and tasks are not yet ported.
    ``calib_batches``: preprocessed NCHW f32 batches for calibration.
    ``model``: a built module to serve instead of a fresh
    ``get_model(model_name, device=device, **model_kwargs)``. The closure
    carries ``make_reference_forward()``, the f32 oracle: f32 preprocess and
    the unquantized model, without TF32."""
    if task != "classification":
        raise NotImplementedError(f"task {task!r} is not yet ported")
    if mode not in ("auto", "int8"):
        raise NotImplementedError(f"mode {mode!r} is not yet ported")
    family = get_constructor(model_name).__module__.rsplit(".", 1)[-1]
    if family != "resnet":
        raise NotImplementedError(f"{model_name!r}: only the resnet route is "
                                  f"ported")
    if model is None:
        model = get_model(model_name, device=device, **model_kwargs)
    device = next(model.parameters()).device

    def cls_pre(**kw):
        return classification_preprocess(model_name, source_hw,
                                         model_in_size=model.in_size,
                                         layout="nchw", device=device, **kw)

    pre = cls_pre()
    scales = _calibrate(model, calib_batches, pre, source_hw, device)
    infer, plan = prepare_int8_resnet(model, scales)

    def pipeline(raw_u8) -> torch.Tensor:
        with torch.inference_mode():
            return infer(plan, pre(_as_input(raw_u8, device)))

    def make_reference_forward() -> Callable:
        pre32 = cls_pre(out_dtype=torch.float32)

        def reference(raw_u8) -> torch.Tensor:
            with torch.inference_mode(), no_tf32():
                return model(pre32(_as_input(raw_u8, device)))

        return reference

    pipeline.make_reference_forward = make_reference_forward
    return pipeline
