"""Post-training int8 calibration: per-layer input abs-max."""

from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch import nn

from ..nn.conv import unfused_depthwise

__all__ = ["calibrate_int8"]


def calibrate_int8(model: nn.Module, batches: Iterable) -> Dict[str, float]:
    """Record the abs-max of every ``nn.Conv2d`` and ``nn.Linear`` input over
    ``batches`` (model inputs, or tuples of them).

    Returns {path: amax}, keyed like the JAX package's scales: the module's
    qualified name with '/' for '.', e.g.
    ``features/stage1/unit1/body/conv1/conv`` and ``output``. The model's
    depthwise blocks run unfused (``unfused_depthwise``), so their convs'
    inputs are recorded as the JAX package records every conv's (K6 takes
    the conv, BN and activation in one call that no hook sees)."""
    scales: Dict[str, float] = {}
    batch_amax: Dict[str, torch.Tensor] = {}

    def make_hook(path):
        def hook(_module, args):
            amax = args[0].detach().to(torch.float32).abs().amax()
            prev = batch_amax.get(path)
            batch_amax[path] = amax if prev is None else torch.maximum(
                prev, amax)
        return hook

    handles = [m.register_forward_pre_hook(make_hook(name.replace(".", "/")))
               for name, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.inference_mode(), unfused_depthwise(model):
            for batch in batches:
                args = batch if isinstance(batch, tuple) else (batch,)
                batch_amax.clear()
                model(*args)
                for path, amax in batch_amax.items():
                    scales[path] = max(scales.get(path, 0.0), float(amax))
    finally:
        for h in handles:
            h.remove()
    return scales
