"""Released-checkpoint registry (metainfo) lookups.

The table is the JAX package's ``pytorchcv_tpu/zoo/metainfo.json``, read by
file path so that the JAX package is never imported.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

__all__ = ["get_model_metainfo_dict"]

_METAINFO_PATH = (Path(__file__).resolve().parents[2] / "pytorchcv_tpu" /
                  "zoo" / "metainfo.json")
_METAINFO: Optional[Dict[str, Any]] = None


def get_model_metainfo_dict() -> Dict[str, Any]:
    """{model name: metainfo row}, parsed once."""
    global _METAINFO
    if _METAINFO is None:
        with open(_METAINFO_PATH) as f:
            _METAINFO = json.load(f)
    return _METAINFO
