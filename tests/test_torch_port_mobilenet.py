"""The port's MobileNet family (v1, its B variant, FD-MobileNet, MobileNetV2
and V2b, MobileNetV3) against the JAX package, on the same numpy inputs and
weights: the seven models at 64x64 in f32; the plain versions of the int8
depthwise conv K12, K2's ReLU6 / linear-residual / f32-output modes and
K3's ReLU6 stem against the JAX cells (``quant/mobilenet_int8.py``) they
replace; K6's dividing hswish against the model's; calibration keys and
amaxes; the serving routes; and every conv of the 16 int8-routed names at
224x224 through the wrappers' shape checks. The int8 pipelines against
JAX's are in ``test_torch_port_mobilenet_int8.py``.

Tolerances: f32 logits within 1e-5 of max |logit|; the int8 cells bit for
bit (JAX's cells run op by op, as written: see the int8 file); K3 off by
at most 1 in at most 0.1 % of the elements (its f32 sums run in another
order); calibration amaxes within 1e-5 relative (the f32 convs sum in
another order than XLA's: up to 2.9e-6 measured when written).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.quant import calibrate_int8 as jax_calibrate
from pytorchcv_tpu.quant.mobilenet_int8 import _cell6, _conv_i8
from pytorchcv_tpu.quant.resnet_int8 import _quant
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
import pytorchcv_tpu_torch.quant.mobilenet_int8 as tmi
from pytorchcv_tpu_torch.kernels._build import f32
from pytorchcv_tpu_torch.kernels.dwconv import (MODEL_ACTIVATIONS,
                                                dwconv2d_bn_act)
from pytorchcv_tpu_torch.kernels.dwconv_i8 import dwconv_i8
from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv
from pytorchcv_tpu_torch.kernels.stem import stem_conv
from pytorchcv_tpu_torch.models import get_constructor
from pytorchcv_tpu_torch.nn import (HSwish, dwconv3x3_block, lambda_hswish,
                                    lambda_relu6, unfused_depthwise)
from pytorchcv_tpu_torch.quant import (calibrate_int8, is_mobilenet_v1_tree,
                                       is_mobilenet_v2_tree)
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_SIZE = (64, 64)
_INT8_NAMES = [f"{fam}_{w}" for fam in ("mobilenet", "fdmobilenet",
                                        "mobilenetv2", "mobilenetv2b")
               for w in ("w1", "w3d4", "wd2", "wd4")]


def _randomize_bn(variables, seed):
    """BN scale, bias, mean and var from a seeded numpy generator."""
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


@functools.lru_cache(maxsize=None)
def _pair(name):
    """The JAX model and the port's on the same variables: the port's
    seeded init converted by ``convert_state_dict``, BN randomized, carried
    back by ``load_jax_variables``."""
    tm = pt.get_model(name, in_size=_SIZE, device="cpu")
    jm = ptc.get_model(name, in_size=_SIZE, init=False)
    variables = _randomize_bn(convert_state_dict(
        tm.state_dict(), jm.shape_variables()), 0)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    load_jax_variables(tm, variables)
    return jm, tm


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _cosine(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("name", [
    "mobilenet_wd2", "fdmobilenet_wd2", "mobilenetb_wd2", "mobilenetv2_wd2",
    "mobilenetv2b_wd2", "mobilenetv3_small_w1", "mobilenetv3_large_w1"])
def test_model_matches_jax(name):
    """f32 logits within 1e-5 of max |logit| (measured when written:
    4.7e-7 to 3.1e-6); the eval forward runs K6's plain version on every
    depthwise block with BN and ReLU, ReLU6 or hswish."""
    jm, tm = _pair(name)
    x = np.random.default_rng(3).standard_normal((2, *_SIZE, 3)).astype(
        np.float32)
    ref = np.asarray(jm(jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(_nchw(x)).numpy()
    assert got.shape == ref.shape == (2, 1000)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert err <= 1e-5, err


def _cell_inputs(rng, k, cin, cout):
    x = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, 1 if k == 3 else cin, cout)
                     ).astype(np.int8)
    cell = {"wq": w, "gain": (rng.uniform(0.5, 1.5, cout) * 1e-3
                              ).astype(np.float32),
            "bias": rng.standard_normal(cout).astype(np.float32)}
    return x, cell


def _jcell(cell):
    return {k: jnp.asarray(v) for k, v in cell.items()}


def _cell_relu(xq, s_in, cell, stride, s_out):
    """JAX ``_forward_v1``'s nested ``cell_relu`` (:219-226), as written."""
    y = _conv_i8(xq, cell["wq"], stride).astype(jnp.float32)
    y = jnp.maximum(y * (cell["gain"] * (s_in / 127.0)) + cell["bias"], 0.0)
    if s_out is None:
        return y
    return jnp.clip(jnp.round(y * (127.0 / s_out)), -127, 127).astype(
        jnp.int8)


@pytest.mark.parametrize("c", [24, 32, 96])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("relu6", [False, True])
def test_k12_plain_matches_jax(c, stride, relu6):
    """K12's plain version bit for bit against JAX ``_cell6`` (ReLU6) and
    ``cell_relu`` (ReLU) on their int8 depthwise path."""
    rng = np.random.default_rng(c * 10 + stride)
    x, cell = _cell_inputs(rng, 3, c, c)
    s_in, s_out = 3.7, 5.3
    if relu6:
        ref = _cell6(jnp.asarray(x), s_in, _jcell(cell), stride, True, s_out)
    else:
        ref = _cell_relu(jnp.asarray(x), s_in, _jcell(cell), stride, s_out)
    got = dwconv_i8(torch.from_numpy(x),
                    torch.from_numpy(cell["wq"][:, :, 0]).contiguous(),
                    torch.from_numpy(cell["gain"]) * f32(s_in / 127.0),
                    torch.from_numpy(cell["bias"]), f32(127.0 / s_out),
                    stride, "relu6" if relu6 else "relu")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["relu6_q", "linear_residual", "relu6_f32",
                                  "relu_f32"])
def test_k2_new_modes_match_jax(mode):
    """K2's plain version bit for bit against the JAX steps it runs: the
    expansion (``_cell6`` with ReLU6 and requant), the projection with its
    linear residual (``_forward`` :145-149), the final block (``_cell6``
    with ReLU6, f32) and v1's last pointwise conv (``cell_relu``, f32)."""
    rng = np.random.default_rng(len(mode))
    x, cell = _cell_inputs(rng, 1, 24, 24)
    s_in, s_out = 4.1, 2.9
    xj, cj = jnp.asarray(x), _jcell(cell)
    w = torch.from_numpy(cell["wq"].transpose(3, 0, 1, 2).copy())
    a = torch.from_numpy(cell["gain"]) * f32(s_in / 127.0)
    b = torch.from_numpy(cell["bias"])
    xt = torch.from_numpy(x)
    if mode == "relu6_q":
        ref = _cell6(xj, s_in, cj, 1, True, s_out)
        got = int8_conv(xt, w, a, b, act="relu6", q=f32(127.0 / s_out))
    elif mode == "linear_residual":
        t = _cell6(xj, s_in, cj, 1, relu6=False)
        ref = _quant(t + xj.astype(jnp.float32) * (s_in / 127.0), s_out)
        got = int8_conv(xt, w, a, b, act=None, q=f32(127.0 / s_out),
                        residual=xt, res_scale=f32(s_in / 127.0),
                        linear_res=True)
    elif mode == "relu6_f32":
        ref = _cell6(xj, s_in, cj, 1, relu6=True)
        got = int8_conv(xt, w, a, b, act="relu6", out_f32=True)
    else:
        ref = _cell_relu(xj, s_in, cj, 1, None)
        got = int8_conv(xt, w, a, b, act="relu", out_f32=True)
    ref = np.asarray(ref)
    assert got.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k3_relu6_within_its_gate():
    """K3's plain version with ReLU6 against the JAX v2 stem (``_forward``
    :117-122: bf16 conv summed in f32, bias, clip(0, 6), quant): off by at
    most 1 in at most 0.1 % of the elements."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 30, 34, 3)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    kf = jnp.asarray(rng.standard_normal((3, 3, 3, 16)) * 0.5, jnp.bfloat16)
    bias = rng.standard_normal(16).astype(np.float32)
    s_in = 7.3
    y = jax.lax.conv_general_dilated(
        xb, kf, (2, 2), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    ref = np.asarray(_quant(jnp.clip(y + bias, 0.0, 6.0), s_in))
    got = stem_conv(
        _nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(np.asarray(kf.astype(jnp.float32))).permute(
            2, 0, 1, 3).contiguous().to(torch.bfloat16),
        torch.from_numpy(bias), f32(127.0 / s_in), "relu6").numpy()
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape and diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3, (diff != 0).mean()


def test_k6_dividing_hswish_is_the_models():
    """K6's ``hswish_div`` gives HSwish's bits on the same pre-activation
    (the TPU kernel's ``hswish``, a product by 1/6, does not everywhere);
    depthwise blocks with BN and ReLU, ReLU6 or hswish take K6 in eval mode
    and agree with their unfused conv -> BN -> activation."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 13, 11, generator=g) * 4.0
    w = torch.randn(16, 1, 3, 3, generator=g) * 0.5
    scale, shift = torch.rand(16, generator=g) + 0.5, torch.randn(16,
                                                                  generator=g)
    with torch.no_grad():
        pre = dwconv2d_bn_act(x, w, scale, shift, 1, ((1, 1), (1, 1)),
                              "none")
        got = dwconv2d_bn_act(x, w, scale, shift, 1, ((1, 1), (1, 1)),
                              "hswish_div")
        mult = dwconv2d_bn_act(x, w, scale, shift, 1, ((1, 1), (1, 1)),
                               "hswish")
    assert torch.equal(got, HSwish()(pre))
    assert torch.equal(got, MODEL_ACTIVATIONS["hswish_div"](pre))
    assert not torch.equal(mult, got)
    for act in (True, lambda_relu6(), lambda_hswish()):
        block = dwconv3x3_block(16, 16, stride=2, activation=act).eval()
        with torch.no_grad():
            block.bn.running_mean.normal_(0.0, 0.5, generator=g)
            block.bn.running_var.uniform_(0.5, 2.0, generator=g)
        assert block.fused_dw
        with torch.inference_mode():
            fused = block(x)
            with unfused_depthwise(block):
                ref = block(x)
        err = float((fused - ref).abs().max() / ref.abs().max())
        assert err <= 1e-6, (act, err)


@pytest.mark.parametrize("name", ["mobilenetv2_wd2", "mobilenet_wd2",
                                  "mobilenetv3_small_w1"])
def test_calibration_matches_jax(name):
    """``calibrate_int8`` records every conv's input, the depthwise ones
    (unfused for it) and the SE and head convs included, under JAX's keys;
    amaxes within 1e-5 relative."""
    jm, tm = _pair(name)
    x = np.random.default_rng(5).standard_normal((4, *_SIZE, 3)).astype(
        np.float32)
    want = jax_calibrate(jm, [jnp.asarray(x)])
    got = calibrate_int8(tm, [_nchw(x)])
    assert set(got) == set(want)
    assert any(k.endswith("/conv2/conv") or k.endswith("/dw_conv/conv")
               for k in got)
    rel = max(abs(got[k] - want[k]) / want[k] for k in want)
    assert rel <= 1e-5, rel


def test_serving_routes_on_cpu():
    """``make_serving_fn`` picks the int8 ``mobilenet_v1`` and
    ``mobilenetv2`` pipelines, bf16 for MobileNetV3 (no int8 route in auto)
    and ``mobilenetb`` (its tree fails the v1 check), as JAX ``serve.py:
    295-305``; ``mode='int8'`` raises on both; the int8 routes' logits
    agree with the f32 oracle."""
    raw = np.random.default_rng(0).integers(0, 256, (2, 74, 74, 3),
                                            dtype=np.uint8)
    for name, route in (("mobilenet_wd4", "mobilenet_v1"),
                        ("fdmobilenet_wd4", "mobilenet_v1"),
                        ("mobilenetv2_wd4", "mobilenetv2"),
                        ("mobilenetv2b_wd4", "mobilenetv2"),
                        ("mobilenetv3_small_w7d20", "bf16"),
                        ("mobilenetb_wd4", "bf16")):
        serve = pt.make_serving_fn(name, (74, 74), device="cpu",
                                   in_size=_SIZE)
        assert serve.route == route, name
        logits = serve(raw)
        assert logits.shape == (2, 1000) and logits.dtype == torch.bfloat16
        if route != "bf16":
            ref = serve.make_reference_forward()(raw)
            cos = float(F.cosine_similarity(logits.float().flatten(),
                                            ref.flatten(), dim=0))
            assert cos >= 0.99, (name, cos)
    for name in ("mobilenetb_wd4", "mobilenetv3_small_w7d20"):
        with pytest.raises(NotImplementedError):
            pt.make_serving_fn(name, (74, 74), mode="int8", device="cpu",
                               in_size=_SIZE)


# Kernel calls per forward, read from the model (PERF.md section 2's
# launch gates): K3, K12, K2.
_CALLS = {"mobilenetv2_w1": (1, 17, 35), "mobilenetv2b_w1": (1, 17, 34),
          "mobilenet_w1": (1, 13, 13)}


@pytest.mark.parametrize("name", _INT8_NAMES)
def test_int8_route_shapes_at_224(name, monkeypatch):
    """Every conv of the name's int8 plan at 224x224 (under
    ``FakeTensorMode``: shapes only) passes the wrappers' checks after
    ``prepare``, K2's Cin % 4 == 0 included (the padded 18- and 6-channel
    maps of the w3d4 and wd4 v2 models); the calls per forward match the
    launch gates."""
    calls = {"stem": 0, "dw": 0, "k2": []}

    def count(key, kernel):
        def wrapped(x, *a, **k):
            if key == "k2":
                calls[key].append((x.shape[-1], a[0].shape))
            else:
                calls[key] += 1
            return kernel(x, *a, **k)
        return wrapped
    monkeypatch.setattr(tmi, "int8_conv", count("k2", int8_conv))
    monkeypatch.setattr(tmi, "dwconv_i8", count("dw", dwconv_i8))
    monkeypatch.setattr(tmi, "stem_conv", count("stem", stem_conv))
    with FakeTensorMode():
        model = get_constructor(name)().eval()
        v1 = name.startswith(("mobilenet_", "fdmobilenet_"))
        assert (is_mobilenet_v1_tree if v1 else is_mobilenet_v2_tree)(model)
        scales = {n.replace(".", "/"): 1.0 for n, m in model.named_modules()
                  if isinstance(m, torch.nn.Conv2d)}
        prep = tmi.prepare_int8_mobilenet_v1 if v1 else \
            tmi.prepare_int8_mobilenet
        run, plan = prep(model, scales)
        with torch.inference_mode():
            out = run(plan, torch.empty(2, 3, 224, 224, dtype=torch.bfloat16))
    assert tuple(out.shape) == (2, 1000) and out.dtype == torch.bfloat16
    assert all(cin % 4 == 0 and w[3] == cin for cin, w in calls["k2"])
    if name in _CALLS:
        assert (calls["stem"], calls["dw"], len(calls["k2"])) == \
            _CALLS[name]
