"""The port's VGG and DarkNet-53 against the JAX package: the f32 forwards
(vgg11, bn_vgg11, bn_vgg11b and darknet53 at 64x64, the JAX test sizes of
``tests/test_quant.py:152-194``) within 1e-5 of max |logit|; the plain
versions of the kernel modes these routes add against the JAX functions
they replace (K2's leaky act, its act-then-residual and its fc layers as
1x1 convs, K3 at stride 1, the 2x2 ``maxpool_i8``); the int8 VGG and
DarkNet pipelines against the JAX pipelines run op by op (un-jitted: under
``jax.jit`` XLA:CPU fuses ``acc * A + B`` into one multiply-add), every
int8 map bit for bit on exact stems (kernel k/64, BN scale 1, var + eps in
{1/4, 1, 4}, a 1/4-grid image: the stem's products sum exactly in any
order), logits within one bf16 step; the tree checks' verdicts against
JAX's on the trees ``test_quant.py`` checks and on trees off the layout;
and ``make_serving_fn`` on the CPU (the route, bf16 for a tree off its
check in auto, ``NotImplementedError`` in int8).

Weights are the port's seeded init with BN and biases randomized, carried
to JAX by ``convert_state_dict`` and back by ``load_jax_variables``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
import pytorchcv_tpu.quant.darknet_int8 as jdk
import pytorchcv_tpu.quant.vgg_int8 as jvgg
from pytorchcv_tpu.quant.resnet_int8 import _conv_i8 as jax_conv_i8
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
import pytorchcv_tpu_torch.quant.darknet_int8 as tdk
import pytorchcv_tpu_torch.quant.vgg_int8 as tvgg
from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv
from pytorchcv_tpu_torch.kernels.stem import maxpool_i8, stem_conv
from pytorchcv_tpu_torch.quant import (calibrate_int8, is_darknet53_tree,
                                       is_plain_vgg)
from pytorchcv_tpu_torch.serve import make_serving_fn
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_SIZE = (64, 64)
_TOL = 1e-5                 # f32 forwards: max |err| / max |logit|


def randomize(tm, seed, exact=False):
    """BN statistics and affine and every bias from a seeded generator, in
    place. With ``exact``, every ``var + eps`` is 1/4, 1 or 4 (rsqrt exact,
    so both packages fold the same constants), and the first conv's kernel
    is k/64 (|k| <= 16) with BN scale 1: its folded bf16 kernel and a
    1/4-grid image sum exactly in f32 in any order."""
    rng = np.random.default_rng(seed)
    first = None
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    (rng.standard_normal(c) * 0.1).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(
                    (rng.standard_normal(c) * 0.5).astype(np.float32)))
                var = rng.choice(np.float32([0.25, 1.0, 4.0]), c) - \
                    np.float32(1e-5) if exact else \
                    rng.uniform(0.5, 2.0, c).astype(np.float32)
                m.running_var.copy_(torch.from_numpy(var))
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                if first is None and isinstance(m, nn.Conv2d):
                    first = m
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(
                        (rng.standard_normal(m.bias.shape) * 0.1)
                        .astype(np.float32)))
        if exact:
            first.weight.copy_(torch.from_numpy(
                rng.integers(-16, 17, first.weight.shape) / 64.0))
            bn = next((m for m in tm.modules()
                       if isinstance(m, nn.BatchNorm2d)), None)
            if bn is not None and bn.num_features == first.out_channels:
                bn.weight.fill_(1.0)


def pair(name, seed=1, exact=False, hw=_SIZE):
    """The JAX model and the port's on the same variables (``randomize``d,
    carried to JAX by ``convert_state_dict``, back by
    ``load_jax_variables``: strict, so every scope name must match)."""
    tm = pt.get_model(name, in_size=hw, device="cpu")
    randomize(tm, seed, exact)
    jm = ptc.get_model(name, in_size=hw, init=False)
    variables = convert_state_dict(tm.state_dict(), jm.shape_variables())
    load_jax_variables(tm, variables)
    return dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables)), tm


def grid_image(seed, hw=_SIZE, n=2):
    """NHWC f32 input on a 1/4 grid in [-2, 2] (exact in bf16)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (n, *hw, 3)) / 4.0).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def jax_tree(tm):
    """A JAX-shaped variables tree of a torch module (convs HWIO, dense
    (in, out), BN scale/bias/mean/var), for the JAX tree checks."""
    params, stats = {}, {}
    for key, v in tm.state_dict().items():
        *scope, leaf = key.split(".")
        a = v.detach().numpy()
        if leaf == "weight":
            d = params
            name = "scale" if a.ndim == 1 else "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else \
                a.T if a.ndim == 2 else a
        elif leaf == "bias":
            d, name = params, "bias"
        elif leaf in ("running_mean", "running_var"):
            d, name = stats, leaf[8:]
        else:
            continue
        node = d
        for s in scope:
            node = node.setdefault(s, {})
        node[name] = a
    return {"params": params, "batch_stats": stats}


def bf16_steps(got, want):
    """The largest distance in bf16 steps (at the larger magnitude)."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    step = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(got - want) / step).max())


# ---------------------------------------------------------------- f32

@pytest.mark.parametrize("name", ["vgg11", "bn_vgg11", "bn_vgg11b",
                                  "darknet53"])
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

def _i8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


def _jnp(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("stride,k", [(1, 1), (2, 3), (1, 3)])
def test_k2_leaky_and_act_then_residual_match_jax(stride, k):
    """K2's leaky act (JAX ``_cell_lk``) and, at stride 1, its
    act-then-residual epilogue (the DarkUnit's add, JAX ``_forward``
    :123-133) to int8 and to f32, bit for bit."""
    rng = np.random.default_rng(stride * 10 + k)
    x = _i8(rng, (2, 9, 9, 16))
    w = _i8(rng, (24, k, k, 16)) if stride == 2 else _i8(rng, (16, k, k, 16))
    a = torch.from_numpy(rng.uniform(1e-4, 3e-4, w.shape[0])
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(w.shape[0]).astype(np.float32))
    cell = {"wq": _jnp(w.permute(1, 2, 3, 0)), "gain": _jnp(a),
            "bias": _jnp(b)}
    s_in, s_out = 3.7, 1.3
    want = np.asarray(jdk._cell_lk(_jnp(x), s_in, cell, stride, s_out))
    aa = a * np.float32(s_in / 127.0)
    got = int8_conv(x, w, aa, b, stride, act="leaky",
                    q=float(np.float32(127.0 / s_out)))
    np.testing.assert_array_equal(got.numpy(), want)
    if stride != 1:
        return
    t = jdk._cell_lk(_jnp(x), s_in, cell, 1)
    y = t + _jnp(x).astype(jnp.float32) * (s_in / 127.0)
    res = float(np.float32(s_in / 127.0))
    got32 = int8_conv(x, w, aa, b, 1, act="leaky", residual=x,
                      res_scale=res, res_after_act=True, out_f32=True)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(y))
    got8 = int8_conv(x, w, aa, b, 1, act="leaky", residual=x,
                     res_scale=res, res_after_act=True,
                     q=float(np.float32(127.0 / s_out)))
    np.testing.assert_array_equal(got8.numpy(),
                                  np.asarray(jvgg._quant(y, s_out)))


def test_k2_fc_as_1x1_conv_matches_jax_fc():
    """VGG's fc layers on K2 as 1x1 convs over a (B, 1, 1, K) map: fc1's K
    rows permuted to NHWC order read the NHWC map as JAX's ``_fc_i8`` reads
    its NCHW flatten (ReLU + requant), and fc3 in bf16 equals JAX's f32
    logits cast to bf16."""
    rng = np.random.default_rng(7)
    xq = _i8(rng, (3, 2, 2, 32))
    fc = nn.Linear(128, 40)
    with torch.no_grad():
        fc.weight.copy_(torch.from_numpy(rng.standard_normal((40, 128))
                                         .astype(np.float32)))
        fc.bias.copy_(torch.from_numpy(rng.standard_normal(40)
                                       .astype(np.float32)))
    jfc = jvgg._fc_consts({"kernel": _jnp(fc.weight.detach().t()),
                           "bias": _jnp(fc.bias.detach())})
    flat = jnp.transpose(_jnp(xq), (0, 3, 1, 2)).reshape(3, -1)
    for relu, s_out in ((True, 2.5), (False, None)):
        step = tvgg._k2_step(tvgg._fc_cell(fc, (2, 2)), 1.7, s_out,
                             "relu" if relu else None)
        got = tvgg._k2(step, xq.reshape(3, 1, 1, -1)).reshape(3, -1)
        want = jvgg._fc_i8(flat, 1.7, jfc, relu, s_out)
        if s_out is None:
            want = want.astype(jnp.bfloat16).astype(jnp.float32)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("act", ["relu", "leaky"])
def test_k3_stride1_matches_jax_stem(act):
    """K3 at stride 1 (VGG's conv1_1, DarkNet's init block) against the JAX
    stems' conv + bias + act + quant, bit for bit on exact operands."""
    rng = np.random.default_rng(11)
    x = grid_image(12, (20, 24))
    kf = (rng.integers(-16, 17, (3, 3, 3, 32)) / 64.0).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kf, jnp.bfloat16),
        (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32) + bias
    y = jdk._leaky(y) if act == "leaky" else jnp.maximum(y, 0.0)
    want = np.asarray(jvgg._quant(y, 5.0))
    got = stem_conv(nchw(x).to(torch.bfloat16),
                    torch.from_numpy(kf).permute(2, 0, 1, 3).contiguous()
                    .to(torch.bfloat16), torch.from_numpy(bias),
                    float(np.float32(127.0 / 5.0)), act, stride=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_maxpool_2x2_matches_jax():
    """``maxpool_i8(x, 2)`` against JAX ``_maxpool2_i8``, odd sizes too."""
    rng = np.random.default_rng(13)
    for shape in ((2, 8, 8, 16), (1, 7, 9, 4)):
        x = _i8(rng, shape)
        np.testing.assert_array_equal(
            maxpool_i8(x, 2).numpy(), np.asarray(jvgg._maxpool2_i8(_jnp(x))))


# ---------------------------------------------------------------- pipelines

def _record(maps, fn, arg=0):
    def wrapped(*a, **k):
        maps.append(np.asarray(a[arg]))
        return fn(*a, **k)
    return wrapped


@pytest.mark.parametrize("name", ["vgg11", "bn_vgg11", "bn_vgg11b"])
def test_int8_vgg_bit_exact_vs_jax(name, monkeypatch):
    """The int8 VGG against JAX ``prepare_int8_vgg`` op by op: the int8 map
    into every conv and fc layer bit for bit (fc1's in NCHW order), logits
    within one bf16 step."""
    jm, tm = pair(name, exact=True)
    x = grid_image(4)
    scales = calibrate_int8(tm, [nchw(grid_image(5, n=4))])
    want_maps = []
    monkeypatch.setattr(jvgg, "_cell", _record(want_maps, jvgg._cell))
    monkeypatch.setattr(jvgg, "_fc_i8", _record(want_maps, jvgg._fc_i8))
    fn, qtree = jvgg.prepare_int8_vgg(jm, scales)
    want = np.asarray(fn(qtree, jnp.asarray(x)).astype(jnp.float32))
    monkeypatch.undo()
    maps = []
    monkeypatch.setattr(tvgg, "int8_conv", _record(maps, int8_conv))
    run, plan = tvgg.prepare_int8_vgg(tm, scales)
    with torch.inference_mode():
        got = run(plan, nchw(x)).to(torch.float32).numpy()
    assert len(maps) == len(want_maps) == 10
    fc1 = len(plan["convs"])
    maps[fc1] = maps[fc1].reshape(2, 2, 2, 512).transpose(0, 3, 1, 2) \
        .reshape(2, -1)
    maps[fc1 + 1:] = [m.reshape(2, -1) for m in maps[fc1 + 1:]]
    exact = [np.array_equal(m, w) for m, w in zip(maps, want_maps)]
    assert all(exact), exact
    assert (np.abs(want_maps[1]) > 0).mean() > 0.2
    assert bf16_steps(got, want) <= 1.0, bf16_steps(got, want)


def test_int8_darknet_bit_exact_vs_jax(monkeypatch):
    """The int8 DarkNet-53 against JAX ``prepare_int8_darknet`` op by op:
    the int8 map into each of its 51 int8 convs bit for bit, logits within
    one bf16 step."""
    jm, tm = pair("darknet53", exact=True)
    x = grid_image(6)
    scales = calibrate_int8(tm, [nchw(grid_image(7, n=4))])
    want_maps = []
    monkeypatch.setattr(jdk, "_conv_i8", _record(want_maps, jax_conv_i8))
    fn, qtree = jdk.prepare_int8_darknet(jm, scales)
    want = np.asarray(fn(qtree, jnp.asarray(x)).astype(jnp.float32))
    monkeypatch.undo()
    maps = []
    monkeypatch.setattr(tdk, "int8_conv", _record(maps, int8_conv))
    run, plan = tdk.prepare_int8_darknet(tm, scales)
    with torch.inference_mode():
        got = run(plan, nchw(x)).to(torch.float32).numpy()
    assert len(maps) == len(want_maps) == 51
    exact = [np.array_equal(m, w) for m, w in zip(maps, want_maps)]
    assert all(exact), exact
    assert bf16_steps(got, want) <= 1.0, bf16_steps(got, want)


# ---------------------------------------------------------------- checks

def _vgg_off_layout(kind):
    tm = pt.get_model("vgg11", in_size=_SIZE, device="cpu")
    if kind == "5x5":
        tm.features.stage3.unit1.conv = nn.Conv2d(128, 256, 5, padding=2)
    elif kind == "bare_fc2":
        tm.output.fc2 = nn.Linear(4096, 4096)
    return tm


def _darknet_off_layout(kind):
    tm = pt.get_model("darknet53", in_size=_SIZE, device="cpu")
    if kind == "3x3_conv1":
        tm.features.stage2.unit2.conv1.conv = nn.Conv2d(128, 64, 3,
                                                        padding=1)
    return tm


@pytest.mark.parametrize("check,jcheck,tree,want", [
    ("vgg", "vgg", "vgg11", True), ("vgg", "vgg", "bn_vgg11b", True),
    ("vgg", "vgg", "resnet10", False), ("vgg", "vgg", "5x5", False),
    ("vgg", "vgg", "bare_fc2", False), ("vgg", "vgg", "darknet53", False),
    ("darknet", "darknet", "darknet53", True),
    ("darknet", "darknet", "resnet10", False),
    ("darknet", "darknet", "3x3_conv1", False),
    ("darknet", "darknet", "vgg11", False)])
def test_tree_checks_match_jax(check, jcheck, tree, want):
    if tree in ("5x5", "bare_fc2"):
        tm = _vgg_off_layout(tree)
    elif tree == "3x3_conv1":
        tm = _darknet_off_layout(tree)
    else:
        tm = pt.get_model(tree, in_size=_SIZE, device="cpu")
    ours = {"vgg": is_plain_vgg, "darknet": is_darknet53_tree}[check](tm)
    theirs = {"vgg": jvgg.is_plain_vgg,
              "darknet": jdk.is_darknet53_tree}[jcheck](jax_tree(tm))
    assert ours == theirs == want


# ---------------------------------------------------------------- serving

def test_serving_routes_on_cpu():
    """``make_serving_fn`` on the CPU: darknet53 takes the "darknet" route
    and agrees with its f32 oracle; vgg11 the "vgg" route; a DarkNet off
    its layout serves bf16 in auto and raises in int8."""
    raw = np.random.default_rng(2).integers(0, 256, (2, 72, 72, 3),
                                            dtype=np.uint8)
    serve = make_serving_fn("darknet53", (72, 72), device="cpu",
                            in_size=_SIZE)
    assert serve.route == "darknet"
    got = serve(raw).to(torch.float32).numpy()
    ref = serve.make_reference_forward()(raw).numpy()
    assert float((got * ref).sum() / (np.linalg.norm(got) *
                                      np.linalg.norm(ref))) >= 0.99
    calib = [torch.randn(1, 3, 224, 224, generator=torch.Generator()
                         .manual_seed(0))]
    assert make_serving_fn("vgg11", (256, 256), device="cpu",
                           calib_batches=calib).route == "vgg"
    odd = _darknet_off_layout("3x3_conv1")
    assert make_serving_fn("darknet53", (72, 72), device="cpu", model=odd,
                           in_size=_SIZE).route == "bf16"
    with pytest.raises(NotImplementedError, match="check"):
        make_serving_fn("darknet53", (72, 72), mode="int8", device="cpu",
                        model=odd)
