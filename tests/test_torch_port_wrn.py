"""The port's WRN (Wide ResNet, biased convs, no BN) and its int8 serving
route against the JAX package, on the same weights (converted by the JAX
package's ``convert_state_dict``, conv biases randomized from a seed: zero
biases would leave the BN-less fold untested) and the same numpy inputs.

The JAX pipeline resolves ``conv1_stride`` to True for ``wrn50_2`` (its
name does not end in "b"), while WRN strides at conv2: a fault of the
reference that the port routes around by reading every stride from the
model. The int8 comparison therefore holds the port against JAX's
``prepare_int8_resnet(..., conv1_stride=False)``; one test shows that JAX's
default differs.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.model import Model
from pytorchcv_tpu.models.wrn import WRN as JaxWRN
from pytorchcv_tpu.quant import resnet_int8 as jq
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.model_provider import _init_weights
from pytorchcv_tpu_torch.models import get_constructor
from pytorchcv_tpu_torch.models.wrn import WRN
from pytorchcv_tpu_torch.quant import prepare_int8_resnet
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)


def _pair(channels, size, classes, seed, exact_stem=False):
    """A reduced WRN (width factor 2) in both packages on one set of
    variables. With ``exact_stem`` the stem kernel lies on a 2**-7 grid and
    the head is the identity (``classes`` = the last width), so that an
    integer image passes the bf16 stem exactly."""
    tm = WRN(channels, 64, 2.0, in_size=size, num_classes=classes)
    _init_weights(tm, 0)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(torch.from_numpy(
                    (rng.standard_normal(m.out_channels) * 0.1)
                    .astype(np.float32)))
        if exact_stem:
            w = tm.features.init_block.conv.conv.weight
            w.copy_(torch.from_numpy(rng.integers(-127, 128, tuple(w.shape))
                                     .astype(np.float32) / 128.0))
            tm.output.weight.copy_(torch.eye(classes))
            tm.output.bias.zero_()
    tm.eval()
    # Named as the registered model, so the JAX pipeline resolves its
    # conv1_stride as it does for wrn50_2.
    jm = Model(name="wrn50_2", module=JaxWRN(channels, 64, 2.0, in_size=size,
                                              num_classes=classes))
    variables = convert_state_dict(tm.state_dict(), jm.shape_variables())
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    return jm, tm


def test_f32_wrn_matches_jax():
    """Also: the JAX tree loads back into a fresh port WRN through
    ``load_jax_variables``, leaf for leaf (the parameter paths match)."""
    jm, tm = _pair([[64, 64], [128, 128]], (32, 32), 1000, 1)
    fresh = WRN([[64, 64], [128, 128]], 64, 2.0, in_size=(32, 32))
    load_jax_variables(fresh, jax.tree_util.tree_map(np.asarray,
                                                     jm.variables))
    for key, value in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)
                                                 ).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 1000)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= 1e-5, rel


def test_wrn50_2_strides_at_conv2():
    """Full size under FakeTensorMode (its parameter count, output shape
    and route are the registry tier's, tests/test_torch_port_registry.py):
    each stage's first unit strides at its 3x3, as the reference's
    WRNBottleneck does, which the int8 plan reads from the model."""
    with FakeTensorMode():
        model = get_constructor("wrn50_2")()
    for stage in (model.features.stage2, model.features.stage3,
                  model.features.stage4):
        body = stage.unit1.body
        assert body.conv1.conv.stride == (1, 1)
        assert body.conv2.conv.stride == (2, 2)
        assert body.conv1_stride is False


def _scales(tm, seed):
    rng = np.random.default_rng(seed)
    return {name.replace(".", "/"): float(rng.uniform(1.0, 4.0))
            for name, m in tm.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}


@pytest.fixture(scope="module")
def int8_case():
    """Three stages at 16x16: the last map is 1x1, so the logits show every
    int8 tensor of the pipeline bit for bit."""
    jm, tm = _pair([[64, 64], [128, 128], [256, 256]], (16, 16), 256, 3,
                   exact_stem=True)
    scales = _scales(tm, 4)
    x = np.random.default_rng(5).integers(-8, 9, (2, 3, 16, 16)
                                          ).astype(np.float32)
    return jm, tm, scales, x


def _jax_logits(jm, scales, x, **kw):
    fn, qtree = jq.prepare_int8_resnet(jm, scales, **kw)
    return np.asarray(jax.jit(fn)(qtree, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))


def test_int8_wrn_plan_bit_exact_vs_jax(int8_case):
    jm, tm, scales, x = int8_case
    want = _jax_logits(jm, scales, x, conv1_stride=False)
    infer, plan = prepare_int8_resnet(tm, scales)
    assert [len(u["chain"]["q"]) for u in plan["units"] if "chain" in u] \
        == [2, 1]
    got = infer(plan, torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    assert (want != 0).mean() > 0.2
    with pytest.raises(ValueError, match="contradicts"):
        prepare_int8_resnet(tm, scales, conv1_stride=True)


def test_jax_default_stride_differs_on_wrn(int8_case):
    """The reference fault: JAX's default resolves conv1_stride to True for
    wrn50_2, which strides the int8 bottleneck at conv1."""
    jm, tm, scales, x = int8_case
    assert jq._resolve_conv1_stride(ptc.get_model("wrn50_2", init=False),
                                    None) is True
    default = _jax_logits(jm, scales, x)
    infer, plan = prepare_int8_resnet(tm, scales)
    got = infer(plan, torch.from_numpy(x).to(torch.bfloat16))
    assert not np.array_equal(got.to(torch.float32).numpy(), default)


def test_wrn_serving_route_on_cpu():
    """``make_serving_fn("wrn50_2", ...)`` at full width (56x56 crop): the
    resnet route, finite logits close to the f32 reference forward."""
    serve = pt.make_serving_fn("wrn50_2", (64, 64), device="cpu",
                               in_size=(56, 56))
    assert serve.route == "resnet"
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)
    y = serve(raw).to(torch.float32)
    yf = serve.make_reference_forward()(raw).to(torch.float32)
    assert tuple(y.shape) == (2, 1000) and bool(torch.isfinite(y).all())
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    assert cos >= 0.99, cos
