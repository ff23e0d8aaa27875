"""Model registry: name -> constructor, filled by ``register_model``."""

from __future__ import annotations

from typing import Callable, Dict, List

_models: Dict[str, Callable] = {}


def register_model(name: str) -> Callable:
    """Decorator registering a model constructor under ``name``."""

    def wrap(fn: Callable) -> Callable:
        assert name not in _models, f"duplicate model name: {name}"
        _models[name] = fn
        return fn

    return wrap


def registered_models() -> List[str]:
    return sorted(_models)


def get_constructor(name: str) -> Callable:
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Unsupported model: {name}")
    return _models[name]
