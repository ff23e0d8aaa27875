"""The port's EfficientNet bf16 serving slice against the JAX package, on
the same numpy inputs and weights: K6's plain version (depthwise conv +
folded BN + activation) against the JAX ``dwconv2d_bn_act`` run through
the Pallas interpreter, the K6 wrapper's CPU contract, the eval-mode
depthwise block against its unfused conv -> BN -> swish, EfficientNet-B0
and -B0b (eps 1e-3, TF-SAME pads) at 64x64 in f32 and bf16 with weights
carried by ``load_jax_variables``, and the serving routes on the CPU.

Tolerances: K6 f32 within 2e-5 (``tests/test_pallas_kernels.py``'s), bf16
within 1 bf16 ulp at no finer than 1/256 of the largest value
(``bf16_ulp_error``); f32 logits within 1e-4 of max |logit|; bf16 logits
at cosine >= 0.99, since JAX's bf16 model rounds after the conv and again
after BN, where K6 keeps f32 until its one cast.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.kernels.dwconv import dwconv2d_bn_act as jax_dwconv
from pytorchcv_tpu.models.efficientnet import \
    calc_tf_padding as jax_tf_padding
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from pytorchcv_tpu_torch.kernels.dwconv import (ACTIVATIONS, dwconv2d_bn_act,
                                                dwconv2d_bn_act_reference)
from pytorchcv_tpu_torch.kernels.preprocess import bf16_ulp_error
from pytorchcv_tpu_torch.models.efficientnet import calc_tf_padding
from pytorchcv_tpu_torch.nn import (dwconv3x3_block, dwconv5x5_block,
                                    lambda_swish, unfused_depthwise)
from pytorchcv_tpu_torch.serve import as_bfloat16
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_SIZE = (64, 64)


def _bf16(a):
    """numpy f32 -> the same values rounded to bf16, as f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _dw_inputs(rng, n, c, h, w, k):
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    wgt = (rng.standard_normal((c, 1, k, k)) * 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.3).astype(np.float32)
    return x, wgt, scale, shift


def _check_dwconv(x, wgt, scale, shift, stride, pad, act):
    """The plain version against the JAX Pallas kernel (interpret mode) on
    the same values, in f32 and in bf16."""
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            x, wgt = _bf16(x), _bf16(wgt)
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        got = dwconv2d_bn_act(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(wgt).to(tdt),
                              torch.from_numpy(scale),
                              torch.from_numpy(shift), stride, pad, act)
        ref = jax_dwconv(jnp.asarray(x.transpose(0, 2, 3, 1), jdt),
                         jnp.asarray(wgt[:, 0].transpose(1, 2, 0), jdt),
                         jnp.asarray(scale), jnp.asarray(shift), stride,
                         pad, act, False, True)
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32))
                               ).permute(0, 3, 1, 2)
        assert got.dtype == tdt and got.shape == ref.shape, (got.shape,
                                                             ref.shape)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                                       rtol=2e-5)
        else:
            err = float(bf16_ulp_error(got, ref).max())
            assert err <= 1, (act, err)


def _tf_pad(h, w, k, stride):
    _, ph, pw, _ = jax_tf_padding(np.zeros((1, h, w, 1)), k, stride)
    return (ph, pw)


@pytest.mark.parametrize("k,stride,h,w,pad,act", [
    (3, 1, 9, 11, ((1, 1), (1, 1)), "swish"),
    (3, 2, 10, 12, "tf", "relu6"),            # TF pad (0, 1) at even sizes
    (5, 1, 7, 9, ((2, 2), (2, 2)), "hswish"),
    (5, 2, 12, 14, "tf", "swish"),            # TF pad (1, 2)
    (5, 2, 11, 13, "tf", "sigmoid"),          # odd sizes: (2, 2)
    (7, 1, 9, 8, ((3, 3), (3, 3)), "relu"),
    (7, 2, 13, 15, "tf", "hsigmoid"),
    (3, 2, 9, 9, ((1, 1), (1, 1)), "none"),
])
def test_dwconv_plain_matches_jax(k, stride, h, w, pad, act):
    x, wgt, scale, shift = _dw_inputs(np.random.default_rng(k * 10 + h), 2,
                                      8, h, w, k)
    if pad == "tf":
        pad = _tf_pad(h, w, k, stride)
        assert pad == calc_tf_padding(torch.empty(1, 1, h, w), k, stride)
    _check_dwconv(x, wgt, scale, shift, stride, pad, act)


@pytest.mark.parametrize("act", list(ACTIVATIONS))
def test_dwconv_activations_match_jax(act):
    x, wgt, scale, shift = _dw_inputs(np.random.default_rng(7), 1, 16, 8, 8,
                                      3)
    x *= 3.0        # both sides of every knee (-3, 0, 3, 6)
    _check_dwconv(x, wgt, scale, shift, 1, ((1, 1), (1, 1)), act)


def test_dwconv_wrapper_cpu_contract():
    """CPU tensors run the plain version and launch nothing; calls off the
    contract raise."""
    x, wgt, scale, shift = (torch.from_numpy(a) for a in _dw_inputs(
        np.random.default_rng(1), 2, 8, 9, 9, 3))
    reset_launch_counts()
    got = dwconv2d_bn_act(x, wgt, scale, shift, 2, ((1, 1), (1, 1)),
                          "swish")
    assert LAUNCHES["dwconv"] == 0
    assert torch.equal(got, dwconv2d_bn_act_reference(
        x, wgt, scale, shift, 2, ((1, 1), (1, 1)), "swish"))
    assert got.shape == (2, 8, 5, 5)
    pad = ((1, 1), (1, 1))
    with pytest.raises(ValueError, match="k in"):
        dwconv2d_bn_act(x, torch.zeros(8, 1, 4, 4), scale, shift, 1, pad,
                        "relu")
    with pytest.raises(ValueError, match="stride"):
        dwconv2d_bn_act(x, wgt, scale, shift, 3, pad, "relu")
    with pytest.raises(ValueError, match="not contiguous"):
        dwconv2d_bn_act(x.transpose(2, 3), wgt, scale, shift, 1, pad, "relu")
    with pytest.raises(ValueError, match="act"):
        dwconv2d_bn_act(x, wgt, scale, shift, 1, pad, "gelu")
    with pytest.raises(ValueError, match="w must be"):
        dwconv2d_bn_act(x, wgt.to(torch.bfloat16), scale, shift, 1, pad,
                        "relu")
    with pytest.raises(ValueError, match="scale"):
        dwconv2d_bn_act(x, wgt, scale.double(), shift, 1, pad, "relu")
    assert LAUNCHES["dwconv"] == 0


def test_eval_depthwise_block_matches_unfused():
    """The eval-mode block (K6's plain version, BN folded) against conv ->
    BN on running statistics -> swish in torch; training mode stays
    unfused."""
    g = torch.Generator().manual_seed(2)
    block = dwconv5x5_block(24, 24, stride=2, activation=lambda_swish())
    with torch.no_grad():
        block.conv.weight.normal_(0.0, 0.2, generator=g)
        bn = block.bn
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
        bn.running_mean.normal_(0.0, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    x = torch.randn(2, 24, 15, 17, generator=g)
    block.eval().requires_grad_(False)
    got = block(x)
    y = F.batch_norm(F.conv2d(x, block.conv.weight, stride=2, padding=2,
                              groups=24), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, False, 0.0, bn.eps)
    ref = y * torch.sigmoid(y)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert got.shape == ref.shape == (2, 24, 8, 9) and err <= 1e-5, err
    # per-call asymmetric pad (TF-SAME): the same as an F.pad in front
    pad = ((0, 1), (1, 2))
    block0 = dwconv5x5_block(24, 24, stride=2, padding=0,
                             activation=lambda_swish()).eval()
    block0.requires_grad_(False)
    block0.load_state_dict(block.state_dict())
    y = F.batch_norm(F.conv2d(F.pad(x, (1, 2, 0, 1)), block.conv.weight,
                              stride=2, groups=24), bn.running_mean,
                     bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
    got = block0(x, pad)
    err = float((got - y * torch.sigmoid(y)).abs().max() / y.abs().max())
    assert err <= 1e-5, err
    block0.train()
    assert block0(x, pad).shape == got.shape     # batch statistics, unfused


def test_dwconv_refuses_calls_autograd_would_record():
    """K6 has no backward: a call with an input that needs a gradient, in
    grad mode, raises on the CPU as on the card; under no_grad it runs."""
    x, wgt, scale, shift = (torch.from_numpy(a) for a in _dw_inputs(
        np.random.default_rng(4), 1, 8, 7, 7, 3))
    pad = ((1, 1), (1, 1))
    for i in range(4):
        args = [x, wgt, scale, shift]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(ValueError, match="no backward"):
            dwconv2d_bn_act(*args, 1, pad, "swish")
        with torch.no_grad():
            assert dwconv2d_bn_act(*args, 1, pad, "swish").shape == x.shape


def test_eval_depthwise_block_routes(monkeypatch):
    """An eval-mode depthwise block calls K6's wrapper only when autograd
    records nothing: with grad enabled it runs unfused and its gradients
    match the unfused module's; ``unfused_depthwise`` keeps K6 out of a
    whole model (the serving oracle) and computes the same function."""
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    calls = []

    def counting(*a, **k):
        calls.append(a[0].shape)
        return dwconv2d_bn_act(*a, **k)
    monkeypatch.setattr(conv_mod, "dwconv2d_bn_act", counting)
    g = torch.Generator().manual_seed(6)
    block = dwconv3x3_block(16, 16, activation=lambda_swish()).eval()
    with torch.no_grad():
        block.bn.running_mean.normal_(0.0, 0.5, generator=g)
        block.bn.running_var.uniform_(0.5, 2.0, generator=g)
    x = torch.randn(2, 16, 9, 9, generator=g, requires_grad=True)
    y = block(x)
    y.square().sum().backward()
    assert not calls and x.grad is not None
    grads = [t.grad.clone() for t in (x, block.conv.weight, block.bn.weight)]
    for t in (x, block.conv.weight, block.bn.weight):
        t.grad = None
    with unfused_depthwise(block):
        assert not block.fused_dw
        y_ref = block(x)
        y_ref.square().sum().backward()
    assert block.fused_dw and not calls
    for got, t in zip(grads, (x, block.conv.weight, block.bn.weight)):
        torch.testing.assert_close(got, t.grad, rtol=0, atol=0)
    with torch.no_grad():
        y_k6 = block(x)
    assert len(calls) == 1
    torch.testing.assert_close(y_k6, y.detach(), rtol=1e-5, atol=1e-5)

    model = pt.get_model("efficientnet_b0", in_size=(32, 32),
                         device="cpu").eval()
    xm = torch.randn(1, 3, 32, 32, generator=g)
    calls.clear()
    with torch.inference_mode():
        y_k6 = model(xm)
        assert len(calls) == 16
        with unfused_depthwise(model):
            y_ref = model(xm)
    assert len(calls) == 16
    torch.testing.assert_close(y_k6, y_ref, rtol=1e-4, atol=1e-4)


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


def _pair(name, seed):
    """The JAX model and the port's on the same variables: the port's
    seeded init converted by ``convert_state_dict``, BN randomized, carried
    back by ``load_jax_variables``."""
    tm = pt.get_model(name, in_size=_SIZE, device="cpu")
    jm = ptc.get_model(name, in_size=_SIZE, init=False)
    variables = _randomize_bn(convert_state_dict(
        tm.state_dict(), jm.shape_variables()), seed)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    load_jax_variables(tm, variables)
    return jm, tm, variables


@pytest.fixture(scope="module", params=["efficientnet_b0",
                                        "efficientnet_b0b"])
def effnet(request):
    return _pair(request.param, 0)


def _cosine(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_converter_carries_efficientnet(effnet):
    """Depthwise HWIO (k, k, 1, C) -> OIHW (C, 1, k, k); the SE convs'
    biases and ``output/fc`` through the existing rules."""
    _, tm, variables = effnet
    sd = tm.state_dict()
    p = variables["params"]["features"]["stage3"]["unit1"]
    np.testing.assert_array_equal(
        sd["features.stage3.unit1.conv2.conv.weight"].numpy(),
        p["conv2"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["features.stage3.unit1.conv2.conv.weight"].shape[1:] == \
        (1, 5, 5)
    np.testing.assert_array_equal(
        sd["features.stage3.unit1.se.conv2.bias"].numpy(),
        p["se"]["conv2"]["bias"])
    np.testing.assert_array_equal(
        sd["output.fc.weight"].numpy(),
        variables["params"]["output"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["features.stage1.unit1.dw_conv.bn.running_var"].numpy(),
        variables["batch_stats"]["features"]["stage1"]["unit1"]["dw_conv"]
        ["bn"]["var"])


def test_efficientnet_matches_jax(effnet):
    """f32 logits within 1e-4 of max |logit|; bf16 (``as_bfloat16`` on both
    sides) at cosine >= 0.99. Measured when written: f32 8.1e-7 and 7.8e-7
    of max |logit|, bf16 cosine 0.999973 and 0.999971 (b0, b0b)."""
    jm, tm, _ = effnet
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, *_SIZE, 3)).astype(np.float32)
    ref = np.asarray(jm(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        got = tm(xt).numpy()
        got_bf = as_bfloat16(tm)(xt.to(torch.bfloat16)).float().numpy()
    assert got.shape == ref.shape == (2, 1000)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert err <= 1e-4, err
    ref_bf = np.asarray(jm.as_bfloat16()(jnp.asarray(x)).astype(jnp.float32))
    cos = _cosine(got_bf, ref_bf)
    assert cos >= 0.99, cos


def test_serving_routes_on_cpu():
    """auto on EfficientNet and mode='bf16' on a ResNet serve bf16 against
    their f32 oracle, which runs no K6; int8 on EfficientNet is not ported,
    bf16 segmentation serves a bf16 copy of the whole model, and a task the
    JAX package does not serve raises."""
    raw = np.random.default_rng(0).integers(0, 256, (2, 74, 74, 3),
                                            dtype=np.uint8)
    effnet = pt.get_model("efficientnet_b0", device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in effnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    calls = []

    def counting(*a, **k):
        calls.append(a[0].dtype)
        return dwconv2d_bn_act(*a, **k)
    for name, mode, model in (("efficientnet_b0", "auto", effnet),
                              ("resnet10", "bf16", None)):
        serve = pt.make_serving_fn(name, (74, 74), mode=mode, device="cpu",
                                   model=model)
        assert serve.route == "bf16" and serve.head is None
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(conv_mod, "dwconv2d_bn_act", counting)
            calls.clear()
            logits = serve(raw)
            n_dw = 16 if model is effnet else 0
            assert calls == [torch.bfloat16] * n_dw
            ref = serve.make_reference_forward()(raw)
            assert len(calls) == n_dw       # the oracle runs no K6
        assert logits.shape == (2, 1000) and logits.dtype == torch.bfloat16
        assert ref.dtype == torch.float32
        cos = float(F.cosine_similarity(logits.float().flatten(),
                                        ref.flatten(), dim=0))
        assert cos >= 0.99, (name, cos)
    assert pt.make_serving_fn("resnet10", (74, 74), device="cpu"
                              ).route == "resnet"
    with pytest.raises(NotImplementedError, match="int8 route"):
        pt.make_serving_fn("efficientnet_b0", (74, 74), mode="int8",
                           device="cpu")
    serve = pt.make_serving_fn("danet_resnetd50b_cityscapes", (72, 96),
                               mode="bf16", task="segmentation",
                               device="cpu", in_size=(64, 64))
    assert serve.route == "bf16" and serve.head is None
    with pytest.raises(NotImplementedError, match="task 'depth'"):
        pt.make_serving_fn("resnet10", (74, 74), task="depth", device="cpu")
