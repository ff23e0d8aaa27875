"""The port's int8 MobileNetV2 pipeline on ``mobilenetv2_w3d4``, whose
18-channel maps ``prepare`` pads to 20 for K2, against the JAX package's
on the same weights and JAX's scales at 64x64, map by map (the padded
channels cut off): :func:`check_pipeline` of
``test_torch_port_mobilenet_int8.py``, in a file of its own so that each
file stays under a minute (the JAX pipeline's op-by-op compiles, ~17 s).
"""

import pytest

from test_torch_port_mobilenet_int8 import check_pipeline


@pytest.mark.parametrize("name", ["mobilenetv2_w3d4"])
def test_int8_pipeline_matches_jax(name, monkeypatch):
    check_pipeline(name, monkeypatch)
