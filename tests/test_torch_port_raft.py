"""The port's RAFT and ``ProPainterIterator`` against the JAX package on the
same weights and the same numpy inputs: the functions of ``models/raft.py``
(the coordinate grid, both upsamplings, the correlation pyramid at odd level
sizes, both lookups with coordinates off the map, and the lookups' channel
order: the reference adds the row offset to x, so each level's channels
have the x offset as the slow axis), the new ``ResUnit`` options, every
module of RAFT (both encoder bodies with instance norm, BN or none, both
motion encoders, ``ConvGRU`` with both kernel shapes, ``SepConvGRU``, the
heads, both update blocks), ``raft_things`` and ``raft_small`` at 64x96
with 2 and 3 refinements, with and without ``flow_init``, the bidirectional
flows of a clip, ``RAFTSequencer`` (window sizes at each threshold, window
indices, flows), and the whole pipeline from frames and masks through
``ProPainterIterator`` on a 6-frame 96x176 clip: every chunk, every
buffer's start after each step, and host buffers against device buffers.

Tolerances (f32, ``jax_default_matmul_precision=float32`` from conftest):
the functions and the modules within 1e-5 of the largest output (the same
f32 steps; summation orders of convs and products), the coordinate grid
exact, the lookups' channel order within 1e-3 of values up to ~1,500 (the
positions round in f32); RAFT, its sequencer and the pipeline
within 1e-4 of the largest output (the generator test's: conv summation
orders carried through the refinements and the recurrences); host buffers
bit-equal to device buffers (the same operations on the same values).

JAX variables are drawn from ``jax.eval_shape`` of the init with seeded
numpy draws (no XLA compile of init) and carried into the port by
``load_jax_variables``. In the pipeline, the generator is the one of
``test_torch_port_propainter.py`` (two convs at a hundredth) and RFC is
drawn as ``test_torch_port_rfc.py`` draws it (its last offset convs at a
tenth), at the clip's size.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
import pytorchcv_tpu.models.propainter_ip_stream as jip_stream
import pytorchcv_tpu.models.propainter_rfc_stream as jrfc_stream
import pytorchcv_tpu.models.propainter_stream as jpp_stream
from pytorchcv_tpu.models import raft as jraft
from pytorchcv_tpu.models import resnet as jresnet
from pytorchcv_tpu.models.propainter_stream import \
    ProPainterIterator as JaxIterator
from pytorchcv_tpu.models.raft_stream import RAFTSequencer as JaxSequencer
from pytorchcv_tpu.nn import (lambda_batchnorm2d as jax_bn,
                              lambda_instancenorm2d as jax_in, lambda_relu)
from pytorchcv_tpu.streaming import TensorSequencer as JaxTensorSequencer
import pytorchcv_tpu_torch as pt
import pytorchcv_tpu_torch.models.propainter_ip_stream as pip_stream
import pytorchcv_tpu_torch.models.propainter_rfc_stream as prfc_stream
import pytorchcv_tpu_torch.models.propainter_stream as ppp_stream
from pytorchcv_tpu_torch.models import get_constructor, raft as praft
from pytorchcv_tpu_torch.models.propainter_stream import (ProPainterIterator,
                                                          TensorSequencer)
from pytorchcv_tpu_torch.models.raft_stream import RAFTSequencer
from pytorchcv_tpu_torch.models.resnet import ResUnit
from pytorchcv_tpu_torch.nn import lambda_instancenorm2d
from pytorchcv_tpu_torch.zoo import load_jax_variables
from test_torch_port_propainter import _generators, _masks

torch.set_num_threads(1)

_SIZE = (64, 96)
_CLIP = (96, 176)              # the generator test's size


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _cf(a):
    """(..., H, W, C) numpy -> torch (..., C, H, W)."""
    return _t(np.moveaxis(np.asarray(a, np.float32), -1, -3))


def _cl(t):
    """torch (..., C, H, W) -> numpy (..., H, W, C)."""
    return np.moveaxis(np.asarray(t.detach().to(torch.float32)
                                  if torch.is_tensor(t) else t,
                                  np.float32), -3, -1)


def _close(got, ref, rtol):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def _draw(path, leaf, rng):
    """Kernels U(+-sqrt(6/fan_in)); biases N(0, 0.1), norm scales 1 plus
    it, BN means N(0, 0.1) and variances U(0.5, 2), so that every mapping
    matters."""
    key = path[-1].key
    if key == "kernel":
        bound = np.sqrt(6.0 / np.prod(leaf.shape[:-1]))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
    if key == "var":
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
    noise = (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
    return noise + np.float32(key == "scale")


def _variables(shapes, seed):
    return jax.tree_util.tree_map_with_path(
        functools.partial(_draw, rng=np.random.default_rng(seed)), shapes)


def _module_pair(jmod, tmod, *arrays, seed=0):
    """JAX variables drawn for ``jmod`` on ``arrays``, loaded into
    ``tmod``; returns them."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, arrays))
    variables = _variables(shapes, seed)
    load_jax_variables(tmod, variables)
    tmod.eval()
    return variables


def _apply(module, variables, *arrays):
    """``module.apply`` jitted: one XLA compile instead of one per
    operation."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a))
    return jax.tree_util.tree_map(np.asarray,
                                  fn(variables, *map(jnp.asarray, arrays)))


# -- the functions --------------------------------------------------------

def test_coords_grid_matches_jax():
    got = praft.create_coords_grid(2, 5, 7)
    assert got.shape == (2, 2, 5, 7)
    np.testing.assert_array_equal(
        _cl(got), np.asarray(jraft.create_coords_grid(2, 5, 7)))


def test_upsample_flow_using_mask_matches_jax():
    rs = np.random.RandomState(0)
    flow = rs.randn(2, 6, 7, 2).astype(np.float32) * 3
    mask = rs.randn(2, 6, 7, 576).astype(np.float32) * 3
    ref = jraft.upsample_flow_using_mask(jnp.asarray(flow),
                                         jnp.asarray(mask))
    got = praft.upsample_flow_using_mask(_cf(flow), _cf(mask))
    assert got.shape == (2, 2, 48, 56)
    _close(_cl(got), ref, 1e-5)


def test_upsample_flow_using_interpolation_matches_jax():
    flow = np.random.RandomState(1).randn(2, 5, 7, 2).astype(np.float32)
    ref = jraft.upsample_flow_using_interpolation(jnp.asarray(flow))
    got = praft.upsample_flow_using_interpolation(_cf(flow))
    _close(_cl(got), ref, 1e-5)


def _fmaps(seed, h, w, c=32, b=2):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, w, c).astype(np.float32),
            rs.randn(b, h, w, c).astype(np.float32))


def test_corr_pyramid_matches_jax_at_odd_sizes():
    """13x19 pools to 6x9, 3x4 and 1x2: odd sizes floor."""
    f1, f2 = _fmaps(2, 13, 19)
    ref = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = praft.build_corr_pyramid(_cf(f1), _cf(f2), 4)
    assert [tuple(g.shape) for g in got] == [
        (2 * 13 * 19, 1, 13, 19), (494, 1, 6, 9), (494, 1, 3, 4),
        (494, 1, 1, 2)]
    for g, r in zip(got, ref):
        _close(_cl(g), r, 1e-5)


@pytest.mark.parametrize("fn,hw,radius", [
    ("lookup_corr", (17, 27), 4), ("lookup_corr", (13, 19), 3),
    ("lookup_corr_gather", (17, 27), 4), ("lookup_corr_gather", (17, 27), 3)])
def test_lookup_matches_jax(fn, hw, radius):
    """Coordinates span the map and 4 px beyond each border (windows off
    it: zeros padding); 13x19's last level is 1x2 (the gather divides by
    zero at a level of size 1, so only the product formulation takes
    it)."""
    h, w = hw
    f1, f2 = _fmaps(3, h, w)
    rs = np.random.RandomState(4)
    coords = (rs.rand(2, h, w, 2) * [w + 8, h + 8] - 4.0).astype(np.float32)
    ref = jax.jit(lambda a, b, c: getattr(jraft, fn)(
        jraft.build_corr_pyramid(a, b, 4), c, radius))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords))
    got = getattr(praft, fn)(praft.build_corr_pyramid(_cf(f1), _cf(f2), 4),
                             _cf(coords), radius)
    assert got.shape == (2, 4 * (2 * radius + 1) ** 2, h, w)
    _close(_cl(got), ref, 1e-5)
    if fn == "lookup_corr_gather":
        gathered = got
        got = praft.lookup_corr(praft.build_corr_pyramid(_cf(f1), _cf(f2),
                                                         4), _cf(coords),
                                radius)
        _close(got.numpy(), gathered.numpy(), 1e-5)


@pytest.mark.parametrize("fn", ["lookup_corr", "lookup_corr_gather"])
def test_lookup_keeps_the_reference_channel_order(fn):
    """On levels whose value at (y, x) is 100 x + y, a window inside the map
    holds 100 (cx + dj) + (cy + dk) at channel j (2r+1) + k: the x offset
    is the slow axis. A swapped port samples the same set in another
    order and fails."""
    r, ks, n = 2, 5, 3
    pyramid = []
    for hl, wl in ((24, 32), (12, 16)):
        ys, xs = torch.meshgrid(torch.arange(hl, dtype=torch.float32),
                                torch.arange(wl, dtype=torch.float32),
                                indexing="ij")
        pyramid.append((100.0 * xs + ys).expand(n, 1, hl, wl))
    coords = torch.tensor([[10.25, 8.5], [12.0, 9.75], [14.5, 7.125]])
    got = getattr(praft, fn)(pyramid, coords.reshape(1, n, 1, 2).permute(
        0, 3, 1, 2), r)[0, :, :, 0].T.reshape(n, 2, ks, ks)
    d = torch.arange(-r, r + 1, dtype=torch.float32)
    for i in range(2):
        c = coords / 2 ** i
        want = 100.0 * (c[:, 0, None, None] + d[:, None]) + \
            (c[:, 1, None, None] + d[None, :])
        torch.testing.assert_close(got[:, i], want, rtol=0, atol=1e-3)


# -- the modules ----------------------------------------------------------

def _norms(kind):
    return {"instance": (jax_in(), lambda_instancenorm2d()),
            "bn": (jax_bn(), True), "none": (None, None)}[kind]


@pytest.mark.parametrize("bottleneck,norm,final_body,stride,c_in", [
    (False, "instance", True, 1, 16), (False, "bn", True, 2, 16),
    (True, "none", True, 1, 32), (True, "instance", False, 2, 16),
    (True, "bn", True, 2, 32)])
def test_res_unit_options_match_jax(bottleneck, norm, final_body, stride,
                                    c_in):
    """``bias``, ``normalization`` (instance norm, BN, none) and
    ``final_body_activation`` on both bodies; an identity conv where the
    shape changes."""
    jnorm, tnorm = _norms(norm)
    jmod = jresnet.ResUnit(
        out_channels=32, stride=stride, bias=True, normalization=jnorm,
        bottleneck=bottleneck, conv1_stride=False,
        final_body_activation=lambda_relu() if final_body else None)
    tmod = ResUnit(c_in, 32, stride, bottleneck, conv1_stride=False,
                   bias=True, normalization=tnorm,
                   final_body_activation=final_body)
    x = np.random.RandomState(5).randn(2, 12, 10, c_in).astype(np.float32)
    variables = _module_pair(jmod, tmod, x)
    with torch.no_grad():
        got = tmod(_cf(x))
    _close(_cl(got), _apply(jmod, variables, x), 1e-5)


@pytest.mark.parametrize("norm,bottleneck,dropout", [
    ("instance", False, 0.0), ("bn", False, 0.5), ("none", True, 0.0),
    ("instance", True, 0.0)])
def test_encoder_matches_jax(norm, bottleneck, dropout):
    """The feature net's instance norm and the context net's BN or none,
    on basic and bottleneck bodies; dropout is off in eval mode."""
    jnorm, tnorm = _norms(norm)
    mid = ((16, 16), (24, 24), (32, 32))
    jmod = jraft.RAFTEncoder(init_block_channels=16, mid_channels=mid,
                             final_block_channels=40, bottleneck=bottleneck,
                             normalization=jnorm, dropout_rate=dropout)
    tmod = praft.RAFTEncoder(3, 16, mid, 40, bottleneck, tnorm, dropout)
    x = np.random.RandomState(6).rand(2, 32, 48, 3).astype(np.float32)
    variables = _module_pair(jmod, tmod, x)
    with torch.no_grad():
        got = tmod(_cf(x))
    assert got.shape == (2, 40, 4, 6)
    _close(_cl(got), _apply(jmod, variables, x), 1e-5)


@pytest.mark.parametrize("corr_list", [(24, 16), (24,)])
def test_motion_encoder_matches_jax(corr_list):
    jmod = jraft.RAFTMotionEncoder(corr_out_channels_list=corr_list,
                                   flow_out_channels_list=(16, 8),
                                   mout_out_channels=14)
    tmod = praft.RAFTMotionEncoder(36, corr_list, (16, 8), 14)
    rs = np.random.RandomState(7)
    corr = rs.randn(1, 6, 8, 36).astype(np.float32)
    flow = (rs.randn(1, 6, 8, 2) * 3).astype(np.float32)
    variables = _module_pair(jmod, tmod, corr, flow)
    with torch.no_grad():
        got = tmod(_cf(corr), _cf(flow))
    assert got.shape == (1, 16, 6, 8)
    _close(_cl(got), _apply(jmod, variables, corr, flow), 1e-5)


@pytest.mark.parametrize("gru", ["3x3", "1x5", "5x1", "separable"])
def test_gru_matches_jax(gru):
    if gru == "separable":
        jmod, tmod = jraft.SepConvGRU(hidden_dim=12), praft.SepConvGRU(12, 20)
    else:
        ks, pd = {"3x3": (3, 1), "1x5": ((1, 5), (0, 2)),
                  "5x1": ((5, 1), (2, 0))}[gru]
        jmod = jraft.ConvGRU(hidden_dim=12, kernel_size=ks, padding=pd)
        tmod = praft.ConvGRU(12, 20, ks, pd)
    rs = np.random.RandomState(8)
    h = np.tanh(rs.randn(1, 7, 9, 12)).astype(np.float32)
    x = rs.randn(1, 7, 9, 20).astype(np.float32)
    variables = _module_pair(jmod, tmod, h, x)
    with torch.no_grad():
        got = tmod(_cf(h), _cf(x))
    _close(_cl(got), _apply(jmod, variables, h, x), 1e-5)


@pytest.mark.parametrize("head", ["flow", "mask"])
def test_heads_match_jax(head):
    if head == "flow":
        jmod, tmod = jraft.FlowHead(mid_channels=16), praft.FlowHead(12, 16)
    else:
        jmod = jraft.MaskHead(mid_channels=16, out_channels=576)
        tmod = praft.MaskHead(12, 16, 576)
    x = np.random.RandomState(9).randn(1, 5, 6, 12).astype(np.float32)
    variables = _module_pair(jmod, tmod, x)
    with torch.no_grad():
        got = tmod(_cf(x))
    _close(_cl(got), _apply(jmod, variables, x), 1e-5)


@pytest.mark.parametrize("sep_gru,mask_out", [(True, 576), (False, 0)])
def test_update_block_matches_jax(sep_gru, mask_out):
    """raft_things' shape (separable GRU, two corr convs, the mask head
    times 0.25) and raft_small's (one GRU, one corr conv, no mask)."""
    corr_list = (24, 16) if sep_gru else (24,)
    jmod = jraft.RAFTUpdateBlock(
        hidden_dim=12, corr_out_channels_list=corr_list,
        flow_out_channels_list=(16, 8), mout_out_channels=14,
        sep_gru=sep_gru, flow_mid_channels=16, mask_out_channels=mask_out)
    tmod = praft.RAFTUpdateBlock(12, 10, 36, corr_list, (16, 8), 14, sep_gru,
                                 16, mask_out)
    rs = np.random.RandomState(10)
    net = np.tanh(rs.randn(1, 6, 8, 12)).astype(np.float32)
    inp = np.maximum(rs.randn(1, 6, 8, 10), 0).astype(np.float32)
    corr = rs.randn(1, 6, 8, 36).astype(np.float32)
    flow = (rs.randn(1, 6, 8, 2) * 3).astype(np.float32)
    variables = _module_pair(jmod, tmod, net, inp, corr, flow)
    ref = _apply(jmod, variables, net, inp, corr, flow)
    with torch.no_grad():
        got = tmod(*map(_cf, (net, inp, corr, flow)))
    assert (got[1] is None) == (mask_out == 0)
    for g, r in zip(got, ref):
        if g is not None:
            _close(_cl(g), r, 1e-5)


# -- RAFT -----------------------------------------------------------------

# raft_things takes frames in [-1, 1] (in_normalize=False, as the
# sequencer builds it), raft_small 0..255 RGB.
_RAFTS = {"raft_things": dict(in_normalize=False, iters=2),
          "raft_small": dict(in_normalize=True, iters=3)}


def _raft_pair(name, flow_head=1.0):
    """The JAX handle and the port's model of ``name`` (``_RAFTS``'s
    configuration) on one set of numpy weights, the flow head's last conv
    times ``flow_head``."""
    kw = _RAFTS[name]
    jm = ptc.get_model(name, init=False, in_size=_SIZE, **kw)
    variables = _variables(jm.shape_variables(), seed=sorted(_RAFTS).index(
        name))
    variables["params"]["update_block"]["flow_head"]["conv2"]["kernel"] *= \
        np.float32(flow_head)
    tm = pt.get_model(name, device="cpu", in_size=_SIZE, **kw)
    load_jax_variables(tm, variables)
    return dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables)), tm


@pytest.fixture(scope="module")
def rafts():
    """name -> (JAX handle, the port's model) on one set of numpy
    weights."""
    return {name: _raft_pair(name) for name in _RAFTS}


def _moving_clip(seed, t, size, scale):
    """(t, H, W, 3) frames: a smooth seeded texture shifted by a smoothly
    varying (dx, dy) of up to ~3 px from frame to frame, so that the flows
    mean something. Values in [-1, 1] (``scale`` 1), or 0..255 (``scale``
    127.5)."""
    h, w = size
    rs = np.random.RandomState(seed)
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    waves = [(rs.rand(2) * 0.15 + 0.02, rs.rand(3) * 6.2832)
             for _ in range(6)]
    out = np.zeros((t, h, w, 3), np.float32)
    for i in range(t):
        dx, dy = 2.5 * i + np.sin(i), 1.5 * i
        for (fy, fx), ph in waves:
            for c in range(3):
                out[i, ..., c] += np.sin(fy * (ys + dy) + fx * (xs + dx)
                                         + ph[c]) / 3
    out = np.clip(out, -1.0, 1.0)
    return out if scale == 1 else (out + 1.0) * scale


@pytest.mark.parametrize("name,init", [
    ("raft_things", False), ("raft_things", True), ("raft_small", False),
    ("raft_small", True)])
def test_raft_matches_jax(rafts, name, init):
    """A batch of 2 frame pairs at 64x96 (1/8: 8x12, levels down to 1x1);
    ``flow_init`` a smooth field of a few px."""
    jm, tm = rafts[name]
    scale = 127.5 if _RAFTS[name]["in_normalize"] else 1
    clip = _moving_clip(11, 3, _SIZE, scale)
    a, b = clip[:2], clip[1:]
    extra = {}
    if init:
        extra["flow_init"] = np.broadcast_to(
            np.sin(np.linspace(0, 3, 12))[None, None, :, None] * [2.0, -1.0],
            (2, 8, 12, 2)).astype(np.float32)
    ref = jm(jnp.asarray(a), jnp.asarray(b),
             **{k: jnp.asarray(v) for k, v in extra.items()})
    with torch.no_grad():
        got = tm(_cf(a), _cf(b), **{k: _cf(v) for k, v in extra.items()})
    assert got[0].shape == (2, 2, 8, 12) and got[1].shape == (2, 2, *_SIZE)
    for g, r in zip(got, ref):
        _close(_cl(g), r, 1e-4)


def test_bidirectional_flows_match_jax(rafts):
    jm, tm = rafts["raft_things"]
    clip = _moving_clip(12, 3, _SIZE, 1)
    ref = jraft.calc_bidirectional_optical_flow_on_video_by_raft(
        jm, jnp.asarray(clip))
    with torch.no_grad():
        got = praft.calc_bidirectional_optical_flow_on_video_by_raft(
            tm, _cf(clip))
    assert got.shape == (2, 4, *_SIZE)
    _close(_cl(got), ref, 1e-4)


def test_registry_counts_match_jax():
    """162 names; raft_things and raft_small with the JAX models' parameter
    counts (docs/MODEL_TABLE.md:492-493)."""
    assert len(pt.registered_models()) == 162
    for name, n in (("raft_things", 5257536), ("raft_small", 990162)):
        model = get_constructor(name)()
        assert sum(p.numel() for p in model.parameters()) == n
        assert ptc.get_model(name, init=False, in_size=_SIZE,
                             iters=1).num_params() == n


def _windows(seq, length, ws):
    """A sequencer class's windows as ranges, or AssertionError where its
    index arithmetic refuses them."""
    try:
        index = seq._calc_window_index(length, ws, (64, 96))
    except AssertionError:
        return AssertionError
    return [((m.target.start, m.target.stop), (m.source.start, m.source.stop),
             m.target_start) for m in index]


def test_sequencer_windows_match_jax():
    """Window sizes at each threshold of the frame's larger side, and the
    window indices for clips of 2-25 frames. A window of 1 frame (sides
    above 1980 px) leaves the first window no target in both packages:
    both refuse it."""
    sides = [64, 640, 641, 720, 721, 1280, 1281, 1980, 1981, 4096]
    for a, b in itertools.product(sides, (16, 700)):
        for ws in (None, 1, 5):
            assert RAFTSequencer._calc_window_size(ws, (a, b)) == \
                JaxSequencer._calc_window_size(ws, (a, b)) == \
                RAFTSequencer._calc_window_size(ws, (b, a)), (a, b, ws)
    for length, ws in itertools.product(range(2, 26), (None, 1, 2, 3, 5)):
        got = _windows(RAFTSequencer, length, ws)
        assert got == _windows(JaxSequencer, length, ws), (length, ws)
        assert (got is AssertionError) == (ws == 1)


def test_sequencer_matches_jax(rafts):
    """Five frames, window 2: windows of 1, 2 and 2 pairs (the frame
    before each window joins it), on device and on host buffers."""
    jm, tm = rafts["raft_things"]
    clip = _moving_clip(13, 5, _SIZE, 1)
    ref = np.asarray(JaxSequencer(jnp.asarray(clip), raft_model=jm,
                                  window_size=2)[0:4])
    seq = RAFTSequencer(_cf(clip), raft_model=tm, window_size=2)
    assert [repr(m) for m in seq.window_index] == [
        "0:1:0 <- 0:2", "1:3:0 <- 1:4", "3:4:0 <- 3:5"]
    got = seq[0:4]
    assert got.shape == (4, 4, *_SIZE)
    _close(_cl(got), ref, 1e-4)
    host = RAFTSequencer(_cf(clip), raft_model=tm, window_size=2,
                         host_buffers=True)[0:4]
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, got.numpy())


# -- the pipeline ---------------------------------------------------------

def _rfc_pair(size):
    """The JAX RFC (jitted handle) and the port's on one set of numpy
    weights, drawn as the RFC test draws them (its last offset convs at a
    tenth of the init's scale), at ``size``."""
    jm = ptc.get_model("propainter_rfc", init=False, in_size=size)
    variables = _variables(jm.shape_variables(), seed=3)
    prop = variables["params"]["hg"]["skip_seq"]["skip4"]["feat_prop_module"]
    for d in ("backward_", "forward_"):
        prop["deform_align"][d]["conv_offset"]["conv4"]["conv"]["kernel"] *= \
            np.float32(0.1)
    tm = pt.get_model("propainter_rfc", in_size=size, device="cpu")
    load_jax_variables(tm, variables)
    return dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables)), tm


_STAGES = ("trans_frame_sequencer", "prop_framemask_sequencer",
           "comp_flow_sequencer", "flow_sequencer", "masks", "frames")


def _run(it):
    """Every chunk of an iterator and every stage buffer's start after
    each chunk."""
    chunks, starts = [], []
    for chunk in it:
        chunks.append(chunk)
        starts.append([getattr(it, s).start_pos for s in _STAGES])
    return chunks, starts


def test_iterator_matches_jax():
    """Six frames of 96x176 through RAFT (windows of 2: 1, 2 and 2 pairs),
    RFC, image propagation, the generator (windows at 0 and 5, overlapping
    over all six frames) and the blend, in chunks of 2. Then the same on
    host buffers.

    RAFT's flow head ends in a conv drawn at a tenth of the init's scale
    (the clip moves ~3 px a frame; RAFT's flows reach 7 px, mean 2.5):
    at the init's scale its random flows reach 44 px (mean 10), and RFC's
    deformable alignment, chaotic on random weights, then drifts from the
    JAX package's to 4 % of max |flow| on the same flows (on the CPU)."""
    t = 6
    jr, tr = _raft_pair("raft_things", flow_head=0.1)
    jrfc, trfc = _rfc_pair(_CLIP)
    jgen, tgen = _generators()
    frames = _moving_clip(14, t, _CLIP, 1)
    masks = _masks(15, t, _CLIP)
    kw = dict(raft_window_size=2, step=2)
    ref_chunks, ref_starts = _run(JaxIterator(
        JaxTensorSequencer(jnp.asarray(frames)),
        JaxTensorSequencer(jnp.asarray(masks)), raft_model=jr,
        pprfc_model=jrfc, pp_model=jgen, **kw))

    def port(host):
        return _run(ProPainterIterator(
            TensorSequencer(_cf(frames)), TensorSequencer(_cf(masks)),
            raft_model=tr, pprfc_model=trfc, pp_model=tgen,
            host_buffers=host, device="cpu", **kw))
    chunks, starts = port(False)
    assert [c.shape for c in chunks] == [(2, 3, *_CLIP)] * 3
    assert starts == ref_starts
    assert starts == [[0, 0, 0, 0, 0, 0], [2, 0, 2, 2, 0, 2],
                      [4, 0, 4, 4, 0, 4]]
    for got, ref in zip(chunks, ref_chunks):
        _close(_cl(got), ref, 1e-4)
    out = torch.cat(chunks)
    known = (_cf(masks) == 0).expand_as(out)
    assert torch.equal(out[known], _cf(frames)[known])
    host_chunks, host_starts = port(True)
    assert host_starts == starts
    for h, d in zip(host_chunks, chunks):
        assert isinstance(h, np.ndarray)
        np.testing.assert_array_equal(h, d.numpy())


def _stub_stages(monkeypatch, classes, zeros):
    """Each stage's window computation replaced by zeros of its output's
    length (RAFT: its frames less one; RFC and image propagation: their
    first source's length; the generator: its flows' plus one) and 4
    channels (the frames take 4 too), so that only the engine's window and
    trim arithmetic runs."""
    raft, rfc, ip, it = classes
    for cls, n in ((raft, lambda c: len(c[0]) - 1), (rfc, lambda c: len(c[0])),
                   (ip, lambda c: len(c[0])), (it, lambda c: len(c[2]) + 1)):
        monkeypatch.setattr(cls, "_calc_data_items",
                            lambda self, c, _n=n: zeros(_n(c)))


def test_iterator_trims_like_jax(monkeypatch):
    """Both packages' iterators, stages stubbed, on host buffers, over
    clips of 2-25 frames in steps of 2, 5 and 10 and pp windows of 80 and
    12: each returns every frame
    or refuses the same cases. A step below 10 (twice the generator's
    stride) on a clip of 12 frames or more trims completed flows that the
    generator's next window still reads (its flows start 5 frames before
    its position): the engine's bounds check refuses it in both."""
    _stub_stages(monkeypatch, (
        RAFTSequencer, prfc_stream.ProPainterRFCSequencer,
        pip_stream.ProPainterIPSequencer, ppp_stream.ProPainterITSequencer),
        lambda n: torch.zeros(n, 4, 1, 1))
    _stub_stages(monkeypatch, (
        JaxSequencer, jrfc_stream.ProPainterRFCSequencer,
        jip_stream.ProPainterIPSequencer, jpp_stream.ProPainterITSequencer),
        lambda n: np.zeros((n, 1, 1, 4), np.float32))

    def frames_out(iterator, t, step, pw, **kw):
        try:
            return sum(len(c) for c in iterator(step=step, pp_window_size=pw,
                                                **kw)) == t
        except AssertionError:
            return AssertionError
    models = dict(raft_model=object(), pprfc_model=object(),
                  pp_model=object(), host_buffers=True)
    refused = []
    for t, step, pw in itertools.product(range(2, 26), (2, 5, 10), (80, 12)):
        port = frames_out(functools.partial(
            ProPainterIterator, TensorSequencer(torch.zeros(t, 4, 8, 8)),
            TensorSequencer(torch.zeros(t, 1, 8, 8)), device="cpu",
            **models), t, step, pw)
        ref = frames_out(functools.partial(
            JaxIterator, JaxTensorSequencer(np.zeros((t, 8, 8, 4))),
            JaxTensorSequencer(np.zeros((t, 8, 8, 1))), **models), t, step,
            pw)
        assert port == ref, (t, step, pw)
        if port is AssertionError:
            refused.append((t, step))
    assert refused and min(t for t, _ in refused) == 12
    assert max(step for _, step in refused) < 10
