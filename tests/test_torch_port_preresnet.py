"""The port's PreResNet and SE-PreResNet against the JAX package: the f32
forwards (preresnet18, preresnet50, preresnet50b and sepreresnet16 at
64x64, the JAX test sizes of ``tests/test_quant.py:335-355``) within 1e-5
of max |logit|; the plain versions of the kernel modes this route adds
against the JAX functions they replace (K13, the stream step, with and
without gate, add and pre-activation; K2's pre-activation epilogue; K3's
gain and bf16 output with the bf16 max-pool after it); the int8 pipeline
against JAX ``prepare_int8_preresnet`` run op by op (un-jitted: under
``jax.jit`` XLA:CPU fuses ``acc * A + B`` into one multiply-add), every
int8 map bit for bit on an exact stem (kernel k/64, var + eps in {1/4, 1,
4}, a 1/4-grid image), SE units handed JAX's gate (the squeeze's f32 mean
sums in another order than XLA's), logits within one bf16 step; each
unit's strides as the port reads them from the model against the JAX
package's rule on the model's name; the tree check against JAX
``_is_plain_preresnet``; and ``make_serving_fn`` on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
import pytorchcv_tpu.quant.preresnet_int8 as jpre
from pytorchcv_tpu.quant.resnet_int8 import _conv_i8 as jax_conv_i8
from pytorchcv_tpu.serve import _is_plain_preresnet, _is_plain_resnet
import pytorchcv_tpu_torch as pt
import pytorchcv_tpu_torch.quant.preresnet_int8 as tpre
from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv
from pytorchcv_tpu_torch.kernels.preact import preact
from pytorchcv_tpu_torch.kernels.stem import stem_conv
from pytorchcv_tpu_torch.quant import (calibrate_int8,
                                       is_plain_preresnet_tree,
                                       is_plain_resnet_tree)
from pytorchcv_tpu_torch.serve import make_serving_fn
from test_torch_port_vgg_darknet import (_i8, _jnp, bf16_steps, grid_image,
                                         jax_tree, nchw, pair)

torch.set_num_threads(1)

_SIZE = (64, 64)
_TOL = 1e-5


@pytest.mark.parametrize("name", ["preresnet18", "preresnet50",
                                  "preresnet50b", "sepreresnet16"])
def test_model_matches_jax(name):
    jm, tm = pair(name)
    x = np.random.default_rng(3).standard_normal((2, *_SIZE, 3)).astype(
        np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    assert got.shape == want.shape == (2, 1000)
    assert np.abs(got - want).max() <= _TOL * np.abs(want).max()


# ---------------------------------------------------------------- kernels

def _jax_step(t, idf, gate, g, b, amax):
    """The JAX pipeline's stream step (``preresnet_int8._forward`` :171-181,
    :157): the gate's product (``_se_gate``'s cast), the bf16 add, the next
    unit's ``_pre_quant``."""
    t = t.astype(jnp.float32)
    if gate is not None:
        t = (t.astype(jnp.bfloat16).astype(jnp.float32) * gate[:, None, None]
             ).astype(jnp.bfloat16).astype(jnp.float32)
    r = t if idf is None else (t + idf.astype(jnp.float32)).astype(
        jnp.bfloat16)
    pre = None if g is None else jpre._pre_quant(r.astype(jnp.float32), g, b,
                                                 amax)
    return r, pre


@pytest.mark.parametrize("t_dtype,id_dtype,gated,with_pre", [
    (torch.float32, torch.bfloat16, False, True),
    (torch.float32, torch.float32, False, True),
    (torch.bfloat16, torch.bfloat16, True, True),
    (torch.bfloat16, torch.float32, True, False),
    (torch.bfloat16, None, False, True)])
def test_k13_matches_jax_stream_step(t_dtype, id_dtype, gated, with_pre):
    """K13's plain version against the JAX ops it replaces, C 24 (8-channel
    vectors on the card) and C 20."""
    rng = np.random.default_rng(21)
    for c in (24, 20):
        t = torch.from_numpy(rng.standard_normal((2, 5, 6, c)).astype(
            np.float32) * 3).to(t_dtype)
        idf = None if id_dtype is None else torch.from_numpy(
            rng.standard_normal((2, 5, 6, c)).astype(np.float32)).to(id_dtype)
        gate = torch.from_numpy(rng.uniform(0, 1, (2, c)).astype(np.float32)) \
            if gated else None
        g = torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
        amax = 2.9
        r, pre = preact(t, idf, gate, (g, b) if with_pre else None,
                        float(np.float32(127.0 / amax)) if with_pre else None)
        jr, jp = _jax_step(
            _jnp(t.float()).astype(jnp.bfloat16) if t_dtype == torch.bfloat16
            else _jnp(t), None if idf is None else _jnp(idf.float()).astype(
                jnp.bfloat16 if id_dtype == torch.bfloat16 else jnp.float32),
            None if gate is None else _jnp(gate), _jnp(g) if with_pre else None,
            _jnp(b), amax)
        if idf is None:
            assert r is None
        else:
            np.testing.assert_array_equal(r.float().numpy(),
                                          np.asarray(jr.astype(jnp.float32)))
        if with_pre:
            np.testing.assert_array_equal(pre.numpy(), np.asarray(jp))
        else:
            assert pre is None


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 2), (1, 2)])
def test_k2_pre_activation_epilogue_matches_jax(k, stride):
    """K2's pre-activation epilogue, ``quant(max((acc * A) * G + B, 0))``,
    against JAX's body step (``_conv_i8 * (s_w * h_scale)`` then the next
    conv's ``_pre_quant``), and the last conv's and the identity conv's f32
    ``acc * A``, bit for bit."""
    rng = np.random.default_rng(k * 10 + stride)
    x = _i8(rng, (2, 9, 9, 16)).clamp_min(0)
    w = _i8(rng, (32, k, k, 16))
    s_w = rng.uniform(1e-3, 3e-3, 32).astype(np.float32)
    g = torch.from_numpy(rng.uniform(0.5, 2, 32).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    h_scale, s_n = 2.3 / 127.0, 1.9
    y = jax_conv_i8(_jnp(x), _jnp(w.permute(1, 2, 3, 0)), stride).astype(
        jnp.float32) * (jnp.asarray(s_w) * h_scale)
    a = torch.from_numpy(s_w) * np.float32(h_scale)
    got = int8_conv(x, w, a, b, stride, act="relu",
                    q=float(np.float32(127.0 / s_n)), pre_gain=g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jpre._pre_quant(y, _jnp(g), _jnp(b), s_n)))
    got32 = int8_conv(x, w, a, torch.zeros(32), stride, act=None,
                      out_f32=True)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(y))


def test_k3_gain_bf16_stem_and_pool_match_jax():
    """K3 with the per-channel gain and the bf16 output (PreResNet's stem:
    the unfolded 7x7/s2 kernel, ``max(y * g + b, 0)``, bf16) and the bf16
    3x3/s2 max-pool after it, against JAX's stem, bit for bit on exact
    operands."""
    rng = np.random.default_rng(17)
    x = grid_image(18, (30, 34))
    kf = (rng.integers(-16, 17, (7, 7, 3, 16)) / 64.0).astype(np.float32)
    g = rng.uniform(0.5, 2, 16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kf, jnp.bfloat16),
        (2, 2), [(3, 3), (3, 3)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    y = jnp.maximum(y * g + b, 0.0).astype(jnp.bfloat16)
    r = jax.lax.reduce_window(y, jnp.asarray(-jnp.inf, jnp.bfloat16),
                              jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                              [(0, 0), (1, 1), (1, 1), (0, 0)])
    got = stem_conv(nchw(x).to(torch.bfloat16),
                    torch.from_numpy(kf).permute(2, 0, 1, 3).contiguous()
                    .to(torch.bfloat16), torch.from_numpy(b), None, "relu",
                    gain=torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    np.testing.assert_array_equal(tpre._pool_bf16(got).float().numpy(),
                                  np.asarray(r.astype(jnp.float32)))


# ---------------------------------------------------------------- pipeline

def _jax_gate(t, k1, b1, k2, b2):
    """JAX ``_se_gate``'s gate of ``t``, computed by the JAX package's ops:
    the port's stream step handed JAX's gate."""
    p = jnp.mean(jnp.asarray(t.to(torch.float32).numpy()), axis=(1, 2),
                 keepdims=True)
    h = jnp.maximum(jnp.einsum("bijc,cm->bijm", p, jnp.asarray(k1.numpy()))
                    + jnp.asarray(b1.numpy()), 0.0)
    gate = jax.nn.sigmoid(jnp.einsum("bijm,mc->bijc", h,
                                     jnp.asarray(k2.numpy()))
                          + jnp.asarray(b2.numpy()))
    return torch.from_numpy(np.array(gate[:, 0, 0, :]))


@pytest.mark.parametrize("name", ["preresnet18", "preresnet50b",
                                  "sepreresnet16"])
def test_int8_preresnet_bit_exact_vs_jax(name, monkeypatch):
    """The int8 pipeline against JAX ``prepare_int8_preresnet`` op by op:
    the int8 map into every body and identity conv bit for bit, at the
    same strides, logits within one bf16 step."""
    jm, tm = pair(name, exact=True)
    x = grid_image(8)
    scales = calibrate_int8(tm, [nchw(grid_image(9, n=4))])
    want_maps, want_strides = [], []

    def rec(xq, wq, stride):
        want_maps.append(np.asarray(xq))
        want_strides.append(stride)
        return jax_conv_i8(xq, wq, stride)
    monkeypatch.setattr(jpre, "_conv_i8", rec)
    fn, qtree = jpre.prepare_int8_preresnet(jm, scales)
    want = np.asarray(fn(qtree, jnp.asarray(x)).astype(jnp.float32))
    monkeypatch.undo()
    maps, strides = [], []

    def trec(xq, *a, **k):
        maps.append(xq.numpy())
        strides.append(k["stride"])
        return int8_conv(xq, *a, **k)
    monkeypatch.setattr(tpre, "int8_conv", trec)
    monkeypatch.setattr(tpre, "se_gate", _jax_gate)
    run, plan = tpre.prepare_int8_preresnet(tm, scales)
    with torch.inference_mode():
        got = run(plan, nchw(x)).to(torch.float32).numpy()
    assert strides == want_strides
    assert len(maps) == len(want_maps) == sum(
        len(u["convs"]) + (u["identity"] is not None) for u in plan["units"])
    exact = [np.array_equal(m, w) for m, w in zip(maps, want_maps)]
    assert all(exact), exact
    assert bf16_steps(got, want) <= 1.0, bf16_steps(got, want)


@pytest.mark.parametrize("name", ["preresnet50", "preresnet50b"])
def test_strides_read_from_model_match_jax_name_rule(name):
    """The port reads every stride from the model; the JAX pipeline places
    the bottleneck's stride by the model's name (``conv1_stride``,
    ``preresnet_int8.py:73-76``). On both the strides of every int8 conv
    agree (traced shapes only: ``jax.eval_shape``)."""
    tm = pt.get_model(name, device="cpu")
    scales = {n.replace(".", "/"): 1.0 for n, m in tm.named_modules()
              if isinstance(m, nn.Conv2d)}
    jm = ptc.get_model(name, init=False)
    want = []

    def rec(xq, wq, stride):
        want.append(stride)
        return jax_conv_i8(xq, wq, stride)

    def run(variables, x):
        fn, qtree = jpre.prepare_int8_preresnet(
            dataclasses.replace(jm, variables=variables), scales)
        return fn(qtree, x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpre, "_conv_i8", rec)
        jax.eval_shape(run, jm.shape_variables(),
                       jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    _, plan = tpre.prepare_int8_preresnet(tm, scales)
    got = [s for u in plan["units"] for s in
           [c["stride"] for c in u["convs"]] +
           ([u["identity"]["stride"]] if u["identity"] else [])]
    assert got == want and want.count(2) == 6


# ---------------------------------------------------------------- checks

def _off_layout(kind):
    tm = pt.get_model("preresnet18", in_size=_SIZE, device="cpu")
    unit = tm.features.stage2.unit1
    if kind == "identity_bias":
        unit.identity_conv = nn.Conv2d(64, 128, 1, stride=2, bias=True)
    elif kind == "no_bn":
        unit.body.conv1.bn = None
    return tm


@pytest.mark.parametrize("tree,want", [
    ("preresnet18", True), ("sepreresnet16", True), ("preresnetbc14b", True),
    ("resnet18", False), ("identity_bias", False), ("no_bn", False),
    ("vgg11", False)])
def test_tree_check_matches_jax(tree, want):
    tm = _off_layout(tree) if tree in ("identity_bias", "no_bn") else \
        pt.get_model(tree, in_size=_SIZE, device="cpu")
    assert is_plain_preresnet_tree(tm) == \
        _is_plain_preresnet(jax_tree(tm)) == want
    if tree == "preresnet18":
        assert not is_plain_resnet_tree(tm) and \
            not _is_plain_resnet(jax_tree(tm))


def test_serving_route_on_cpu():
    """``make_serving_fn`` on the CPU: preresnet18 takes the "preresnet"
    route and agrees with its f32 oracle; a tree off the check serves bf16
    in auto and raises in int8."""
    raw = np.random.default_rng(2).integers(0, 256, (2, 72, 72, 3),
                                            dtype=np.uint8)
    serve = make_serving_fn("preresnet18", (72, 72), device="cpu",
                            in_size=_SIZE)
    assert serve.route == "preresnet"
    got = serve(raw).to(torch.float32).numpy()
    ref = serve.make_reference_forward()(raw).numpy()
    assert float((got * ref).sum() / (np.linalg.norm(got) *
                                      np.linalg.norm(ref))) >= 0.99
    odd = _off_layout("identity_bias")
    assert make_serving_fn("preresnet18", (72, 72), device="cpu", model=odd,
                           in_size=_SIZE).route == "bf16"
    with pytest.raises(NotImplementedError, match="check"):
        make_serving_fn("preresnet18", (72, 72), mode="int8", device="cpu",
                        model=odd)
