"""The port's f32 ResNet, calibration and int8 serving slice against the
JAX package, on the same weights (carried by ``load_jax_variables``) and
the same numpy inputs.

JAX BatchNorm scale, bias, mean and var are randomized with a seeded numpy
generator before conversion: channel-constant BN would hide a per-channel
mix-up (the motive of ``randomize_stateful_tensors`` in conftest).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.kernels.preprocess import \
    classification_preprocess as jax_cls_pre
from pytorchcv_tpu.quant import calibrate_int8 as jax_calibrate
from pytorchcv_tpu.quant.resnet_int8 import \
    prepare_int8_resnet as jax_prepare
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels.preprocess import classification_preprocess
from pytorchcv_tpu_torch.quant import calibrate_int8, prepare_int8_resnet
from pytorchcv_tpu_torch.quant.resnet_int8 import UnsupportedTreeError
from pytorchcv_tpu_torch.zoo import ConversionError, load_jax_variables

torch.set_num_threads(1)

_SIZE = (64, 64)


def _randomize_bn(variables, seed):
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k, v in params.items():
            if k == "bn":
                c = v["scale"].shape[0]
                v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
                stats[k]["mean"] = (rng.standard_normal(c) * 0.5
                                    ).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))

    out = jax.tree_util.tree_map(np.array, variables)
    walk(out["params"], out["batch_stats"])
    return out


def _pair(name, seed, **kw):
    """The JAX model and the port's on the same variables: the port's
    seeded init, converted by the JAX package's ``convert_state_dict``
    (the JAX model's own init is an XLA compile of the whole model), BN
    randomized, and carried back by ``load_jax_variables``."""
    tm = pt.get_model(name, in_size=_SIZE, device="cpu", **kw)
    jm = ptc.get_model(name, in_size=_SIZE, init=False, **kw)
    variables = _randomize_bn(convert_state_dict(
        tm.state_dict(), jm.shape_variables()), seed)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    load_jax_variables(tm, variables)
    return jm, tm


@pytest.fixture(scope="module")
def r50():
    return _pair("resnet50", 0, width_scale=0.25)


def _images(seed, n=2, hw=_SIZE):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def _normalized(seed):
    u8 = _images(seed).astype(np.float32)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    return ((u8 / 255.0 - mean) / std).astype(np.float32)


def _max_rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("name", ["resnet50", "resnetbc14b"])
def test_f32_model_matches_jax(name, r50):
    jm, tm = r50 if name == "resnet50" else _pair(name, 1, width_scale=0.25)
    x = _normalized(3)
    ref = np.asarray(jm(jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (2, 1000)
    assert _max_rel(got, ref) <= 2e-4, _max_rel(got, ref)


def test_converter_is_strict(r50):
    jm, _ = r50
    variables = jax.tree_util.tree_map(np.asarray, jm.variables)
    tm = pt.get_model("resnet50", in_size=_SIZE, width_scale=0.25,
                      device="cpu")
    del variables["batch_stats"]["features"]["init_block"]["conv"]["bn"]["var"]
    with pytest.raises(ConversionError, match="left unset"):
        load_jax_variables(tm, variables)
    variables = jax.tree_util.tree_map(np.asarray, jm.variables)
    variables["params"]["features"]["extra"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(ConversionError, match="no torch tensor"):
        load_jax_variables(tm, variables)


def test_calibration_matches_jax(r50):
    jm, tm = r50
    x = _normalized(4)
    ref = jax_calibrate(jm, [jnp.asarray(x)])
    got = calibrate_int8(tm, [torch.from_numpy(x).permute(0, 3, 1, 2)])
    assert set(got) == set(ref)
    assert "features/stage1/unit1/body/conv1/conv" in got and "output" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def _agreement(y8, yf):
    """Cosine, and top-1 agreement over samples with a decisive top-2
    margin (as tests/test_quant.py:_agreement)."""
    cos = float((y8 * yf).sum() / (np.linalg.norm(y8) * np.linalg.norm(yf)))
    top2 = np.sort(yf, axis=1)[:, ::-1][:, :2]
    decisive = (top2[:, 0] - top2[:, 1]) / (np.abs(yf).max(1) + 1e-9) > 0.02
    same = (y8.argmax(1) == yf.argmax(1)) | ~decisive
    return cos, float(same.mean())


def test_int8_slice_matches_jax_pipeline(r50):
    """JAX preprocess + prepare_int8_resnet vs the port's same two, on the
    same weights and JAX's scales."""
    jm, tm = r50
    raw = _images(5, hw=(64, 64))
    jpre = jax_cls_pre(56, (64, 64), layout="nchw")
    scales = jax_calibrate(jm, [jax_cls_pre(56, (64, 64))(jnp.asarray(
        _images(6, n=4))).astype(jnp.float32)])
    fn, qtree = jax_prepare(jm, scales)
    # Jitted: op by op the JAX pipeline compiles every op alone (~8 s).
    ref = np.asarray(jax.jit(fn)(qtree, jpre(jnp.asarray(raw)))
                     .astype(jnp.float32))
    tpre = classification_preprocess(56, (64, 64), layout="nchw",
                                     device="cpu")
    infer, plan = prepare_int8_resnet(tm, scales)
    x = tpre(torch.from_numpy(raw))
    got_t = infer(plan, x)
    # An NHWC model input takes the same stem and gives the same logits.
    assert torch.equal(infer(plan, x.permute(0, 2, 3, 1)), got_t)
    got = got_t.to(torch.float32).numpy()
    assert got.shape == ref.shape == (2, 1000)
    cos, agree = _agreement(got, ref)
    assert cos >= 0.999 and agree == 1.0, (cos, agree)


def test_prepare_raises_on_trees_it_does_not_walk(r50):
    _, tm = r50
    scales = {}
    bad = pt.get_model("resnet10", in_size=_SIZE, device="cpu")
    bad.features.stage1.unit1.body.conv1.conv = torch.nn.Conv2d(
        64, 64, 3, padding=1, groups=2, bias=False)
    with pytest.raises(UnsupportedTreeError, match="grouped"):
        prepare_int8_resnet(bad, scales)
    bad = pt.get_model("resnet10", in_size=_SIZE, device="cpu")
    bad.features.stage2.unit1.se = torch.nn.Identity()
    with pytest.raises(UnsupportedTreeError, match="SE"):
        prepare_int8_resnet(bad, scales)
    bad = pt.get_model("resnet10", in_size=_SIZE, device="cpu")
    bad.features.stage3.unit1.identity_conv.bn.running_var = None
    with pytest.raises(ValueError, match="stage3/unit1/identity_conv.*"
                                         "running statistics"):
        prepare_int8_resnet(bad, scales)
    with pytest.raises(ValueError, match="contradicts"):
        prepare_int8_resnet(tm, scales, conv1_stride=False)
