"""Public entry point: ``get_model(name, ...)``."""

from __future__ import annotations

import math

import torch
from torch import nn

from .models import get_constructor, registered_models

__all__ = ["get_model", "registered_models", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The entry points' device: the card unless the caller asks for
    another. Without a card, only an explicit CPU request runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pytorchcv_tpu_torch runs on a CUDA card by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def _init_weights(module: nn.Module, rng: int) -> None:
    """Seeded init with the JAX package's distributions: 2-D and 3-D convs
    U(+-sqrt(6/fan_in)), linear weights U(+-sqrt(1/fan_in)), biases 0,
    BatchNorm at its defaults. Draws come from a CPU ``torch.Generator``
    in module order, so a seed gives the same weights on every device."""
    g = torch.Generator().manual_seed(rng)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 1.0 if isinstance(m, nn.Linear) else 6.0
                bound = math.sqrt(gain / fan_in)
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                    -bound, bound, generator=g))
                if m.bias is not None:
                    m.bias.zero_()


def get_model(name: str, pretrained: bool = False, rng: int = 0,
              device=None, **kwargs) -> nn.Module:
    """Build a zoo model by registered name, initialized from seed ``rng``,
    on ``device`` (default: the CUDA card; ``"cpu"`` must be asked for), in
    eval mode."""
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not yet ported to pytorchcv_tpu_torch; "
            "build with pretrained=False and load weights with "
            "zoo.convert.load_jax_variables")
    device = resolve_device(device)
    module = get_constructor(name)(**kwargs)
    _init_weights(module, rng)
    return module.to(device).eval()
