"""Registry integrity of the port, for every name it registers: the
parameter count equals the zoo registry's ``params`` (the JAX model's count
for a name without a metainfo row, ``efficientnet_b8``), the output shape
follows the JAX model's declared input size and class count (for a video
model, the JAX model's output shapes on its own example inputs), and the
int8 serving route is the one the JAX package declares for that name.

Models are built and run under ``FakeTensorMode``: shapes propagate through
the real modules (and the kernel wrappers' CPU branch) without allocating
or computing, so the full-size zoo is checked in seconds.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import pytorchcv_tpu as ptc
from pytorchcv_tpu.serve import declared_int8_route as jax_declared_route
from pytorchcv_tpu.zoo import get_model_metainfo_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.models import get_constructor
from pytorchcv_tpu_torch.serve import declared_int8_route

torch.set_num_threads(1)

_NAMES = sorted(pt.registered_models())


@pytest.mark.parametrize("name", _NAMES)
def test_param_count_matches_registry(name):
    with FakeTensorMode():
        model = get_constructor(name)()
    n = sum(p.numel() for p in model.parameters())
    row = get_model_metainfo_dict().get(name)
    want = row["params"] if row else \
        ptc.get_model(name, init=False).num_params()
    assert n == want, f"{name}: got {n}, registry says {want}"


def _video_channels_first(shape):
    """(..., H, W, C) -> (..., C, H, W)."""
    return (*shape[:-3], shape[-1], *shape[-3:-1])


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _check_video_model(name, ref):
    """A model with its own example inputs (ProPainter RFC, IP and the
    generator): the JAX package's output shapes, from ``jax.eval_shape``,
    channels first."""
    args = ref.module.dummy_inputs(1)
    want = [None if o is None else _video_channels_first(o.shape)
            for o in _as_list(ref.eval_output_shape())]
    with FakeTensorMode():
        model = get_constructor(name)().eval()
        with torch.no_grad():
            out = model(*(torch.empty(_video_channels_first(a.shape))
                          for a in args))
    assert [None if o is None else tuple(o.shape)
            for o in _as_list(out)] == want


@pytest.mark.parametrize("name", _NAMES)
def test_output_shape_matches_jax_declaration(name):
    ref = ptc.get_model(name, init=False)   # lazy: no tracing
    if hasattr(ref.module, "dummy_inputs"):
        _check_video_model(name, ref)
        return
    with FakeTensorMode():
        model = get_constructor(name)().eval()
        x = torch.empty(2, ref.in_channels, *ref.in_size)
        with torch.no_grad():
            out = model(x)
    if get_model_metainfo_dict().get(name, {}).get("dataset") == "cs":
        assert isinstance(out, tuple) and len(out) == 3   # main + 2 aux
        for o in out:
            assert tuple(o.shape) == (2, ref.num_classes, *ref.in_size)
    else:
        assert tuple(out.shape) == (2, ref.num_classes)


@pytest.mark.parametrize("name", _NAMES)
def test_int8_route_matches_jax(name):
    for mode in ("auto", "int8"):
        assert declared_int8_route(name, mode) == \
            jax_declared_route(name, mode), (name, mode)
