"""Weights: the JAX-variables carrier and the metainfo table."""

from .convert import ConversionError, load_jax_variables
from .store import get_model_metainfo_dict

__all__ = ["ConversionError", "load_jax_variables", "get_model_metainfo_dict"]
