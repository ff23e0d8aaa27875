"""JAX variables -> torch module: the weight carrier between the packages.

The JAX package's parameter tree mirrors the reference module tree, so one
rule set maps every leaf (the inverse of ``pytorchcv_tpu/zoo/convert.py``):

  JAX leaf                       torch tensor          transform
  params .../kernel (kh,kw,I,O)  .weight (O,I,kh,kw)   transpose (3,2,0,1)
  params .../kernel DHWIO (5-D)  .weight OIDHW         transpose (4,3,0,1,2)
  params .../kernel (I,O)        .weight (O,I)         transpose
  params .../scale               .weight               copy
  params .../bias                .bias                 copy
  params .../alpha               .alpha                copy  (ScaleBlock)
  batch_stats .../mean           .running_mean         copy
  batch_stats .../var            .running_var          copy
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_variables", "ConversionError"]

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "alpha": "alpha"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


class ConversionError(RuntimeError):
    pass


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_value(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def load_jax_variables(module: nn.Module, variables: Dict[str, Any]) -> None:
    """Load ``variables`` ({"params": ..., "batch_stats": ...}, nested dicts
    of arrays) into ``module`` in place. Strict: a JAX leaf with no torch
    tensor, a shape mismatch, or a torch tensor left unset raises."""
    state = module.state_dict()
    expected = {k for k in state if not k.endswith("num_batches_tracked")}
    new: Dict[str, torch.Tensor] = {}
    tables = {"params": _PARAM_LEAVES, "batch_stats": _STAT_LEAVES}
    for collection, tree in variables.items():
        if collection not in tables:
            raise ConversionError(f"unknown collection {collection!r}")
        for path, value in _leaves(tree):
            *scope, leaf = path
            if leaf not in tables[collection]:
                raise ConversionError(
                    f"unknown {collection} leaf {'/'.join(path)}")
            key = ".".join(scope + [tables[collection][leaf]])
            if key not in expected:
                raise ConversionError(
                    f"{collection} leaf {'/'.join(path)} has no torch tensor "
                    f"{key!r}")
            arr = _torch_value(leaf, np.asarray(value, np.float32))
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ConversionError(
                    f"shape mismatch at {key}: JAX {arr.shape} vs torch "
                    f"{tuple(state[key].shape)}")
            new[key] = torch.tensor(np.ascontiguousarray(arr))
    missing = expected - set(new)
    if missing:
        raise ConversionError(f"torch tensors left unset: {sorted(missing)}")
    with torch.no_grad():
        for key, value in new.items():
            state[key].copy_(value)
