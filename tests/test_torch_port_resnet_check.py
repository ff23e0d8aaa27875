"""The tree check on the port's int8 ``resnet`` route
(``quant.is_plain_resnet_tree``) against the JAX package's
``serve._is_plain_resnet``, and the route it decides in
``make_serving_fn``:

* a ``resnet10`` with an extra branch in a unit is served in bf16 in
  ``mode="auto"`` (logits equal to ``as_bfloat16(model)`` on the serving
  preprocess) and raises ``NotImplementedError`` in ``mode="int8"``;
* the port's check and JAX's agree on small trees, each carried into the
  JAX package's parameter tree by its ``zoo/convert.py`` (the extra
  branches included): resnet10, seresnet10, a narrow deep-stem SENet, a
  unit with an extra branch, an SE gate of another layout and a tree
  with ``post_activ``; on a 1x1-conv head they differ by design: JAX
  takes any ``kernel`` leaf at ``output`` (its pipeline then multiplies
  the pooled features by the 4-D conv kernel), the port only a
  ``Linear``, so the port serves that tree in bf16;
* every name the port registers on the ``resnet`` route passes the
  port's check (built on the meta device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import pytorchcv_tpu as ptc
from pytorchcv_tpu.serve import _is_plain_resnet
from pytorchcv_tpu.models.senet import SENet as JaxSENet
from pytorchcv_tpu.model import Model
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels.preprocess import classification_preprocess
from pytorchcv_tpu_torch.models import get_constructor
from pytorchcv_tpu_torch.models.senet import SENet
from pytorchcv_tpu_torch.quant import is_plain_resnet_tree
from pytorchcv_tpu_torch.serve import as_bfloat16, declared_int8_route

torch.set_num_threads(1)

_HW = (64, 64)


def _with_attention(model):
    """An extra conv branch in ``features.stage1.unit1`` (its forward does
    not call it)."""
    model.features.stage1.unit1.attention = nn.Conv2d(64, 64, 1)
    return model


def test_extra_branch_served_in_bf16_in_auto():
    m = _with_attention(pt.get_model("resnet10", device="cpu",
                                     in_size=_HW))
    serve = pt.make_serving_fn("resnet10", _HW, model=m, device="cpu",
                               mode="auto")
    assert serve.route == "bf16" and serve.scales is None
    raw = np.random.default_rng(0).integers(0, 256, (2, *_HW, 3),
                                            dtype=np.uint8)
    pre = classification_preprocess("resnet10", _HW, model_in_size=m.in_size,
                                    layout="nchw", device="cpu")
    with torch.inference_mode():
        want = as_bfloat16(m)(pre(torch.from_numpy(raw)))
    got = serve(raw)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="generic int8"):
        pt.make_serving_fn("resnet10", _HW, model=m, device="cpu",
                           mode="int8")


def _unfreeze(tree):
    """A shape tree as nested plain dicts."""
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return tree


def _extra_leaf(shapes, path, leaves):
    """``shapes`` with a branch at ``path`` of ``leaves`` ({collection:
    {name: shape}})."""
    for collection, named in leaves.items():
        node = shapes.setdefault(collection, {})
        for key in path:
            node = node.setdefault(key, {})
        for name, shape in named.items():
            node[name] = jax.ShapeDtypeStruct(shape, jnp.float32)
    return shapes


_CONV_LEAVES = {"params": {"kernel": (1, 1, 64, 64), "bias": (64,)}}


def _seresnet_bad_se(tm):
    tm.features.stage1.unit1.se.conv3 = nn.Conv2d(64, 64, 1)
    return tm, ("features", "stage1", "unit1", "se", "conv3"), _CONV_LEAVES


def _resnet_attention(tm):
    return _with_attention(tm), ("features", "stage1", "unit1",
                                 "attention"), _CONV_LEAVES


def _resnet_post_activ(tm):
    tm.features.post_activ = nn.BatchNorm2d(512)
    return tm, ("features", "post_activ"), {
        "params": {"scale": (512,), "bias": (512,)},
        "batch_stats": {"mean": (512,), "var": (512,)}}


def _resnet_conv_head(tm):
    tm.output = nn.Conv2d(512, 1000, 1)
    return tm, ("output",), {"params": {"kernel": (1, 1, 512, 1000),
                                        "bias": (1000,)}}


def _senet_pair():
    args = ([[64], [128]], 32, 8, 16)
    tm = SENet(*args, in_size=_HW, num_classes=10)
    jm = Model(name="senet", module=JaxSENet(*args, in_size=_HW,
                                             num_classes=10))
    return tm, jm


# case: (registered name or a pair's constructor, a tree edit, JAX's
# verdict, the port's)
_TREES = {
    "resnet10": ("resnet10", None, True, True),
    "seresnet10": ("seresnet10", None, True, True),
    "senet narrow deep stem": (_senet_pair, None, True, True),
    "resnet10 extra branch": ("resnet10", _resnet_attention, False, False),
    "seresnet10 SE of conv1 conv2 conv3": ("seresnet10", _seresnet_bad_se,
                                           False, False),
    "resnet10 post_activ": ("resnet10", _resnet_post_activ, False, False),
    "resnet10 1x1-conv head": ("resnet10", _resnet_conv_head, True, False),
}


@pytest.mark.parametrize("case", sorted(_TREES))
def test_port_check_agrees_with_jax(case):
    source, edit, jax_verdict, port_verdict = _TREES[case]
    if callable(source):
        tm, jm = source()
    else:
        tm = pt.get_model(source, device="cpu", in_size=_HW)
        jm = ptc.get_model(source, init=False, in_size=_HW)
    shapes = _unfreeze(jm.shape_variables())
    if edit is not None:
        tm, path, leaves = edit(tm)
        shapes = _extra_leaf(shapes, path, leaves)
    variables = convert_state_dict(tm.state_dict(), shapes)
    assert _is_plain_resnet(variables) is jax_verdict
    assert is_plain_resnet_tree(tm) is port_verdict


_RESNET_ROUTE = [n for n in sorted(pt.registered_models())
                 if declared_int8_route(n) == "resnet"]


def test_every_resnet_route_name_passes_the_check():
    assert len(_RESNET_ROUTE) >= 58
    failed = []
    for name in _RESNET_ROUTE:
        with torch.device("meta"):
            model = get_constructor(name)()
        if not is_plain_resnet_tree(model):
            failed.append(name)
    assert not failed, failed
