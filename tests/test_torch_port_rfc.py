"""The port's ProPainter RFC slice against the JAX package on the same
weights and the same numpy inputs: the deformable sampler (K5's plain
version) against the Pallas kernel in interpret mode, ``deform_conv2d`` on
and off its bounded-offset contract against ``_deform_general``, the two
modules that hold the kernel, the whole model at 112x136 (its 1/8 map,
14x17, is at least P = 14, so the contract branch runs), the streaming
sequencer and the window-index arithmetic.

Tolerances (f32, ``jax_default_matmul_precision=float32`` from conftest):
the sampler 1e-5 of max|x| (the same f32 steps; positions relative to the
TPU window may round once more); ``deform_conv2d`` 1e-5 of the largest
output (summation order of the 9*C product); modules and the model 1e-4 of
the largest output (conv summation orders, carried through the
recurrence). bf16 samples within 5 % of the scale, as the JAX package's
own bf16 test.

One JAX model's variables are drawn per module (``jax.eval_shape`` of its
init, then seeded numpy draws: no XLA compile of init) and carried into the
port by ``load_jax_variables``. The last conv of each ``conv_offset`` is
drawn at a tenth of the init's scale (the reference zero-initializes it,
``init_offset``): at full scale the offsets saturate at +-5 px and the
random recurrence is chaotic, so that the JAX package's jitted and
op-by-op runs drift apart to the scale of the flows within 8 frames; at a
tenth they agree far inside the tolerance and the offsets still reach a
few pixels.
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
from pytorchcv_tpu.kernels.deform_patch import deform_sample_patch
from pytorchcv_tpu.models import propainter_rfc as jrfc
from pytorchcv_tpu.models.propainter_rfc_stream import \
    ProPainterRFCSequencer as JaxSequencer
from pytorchcv_tpu.nn.deform import _deform_general
from pytorchcv_tpu.streaming import engine as jeng
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels.deform_patch import (deform_sample,
                                                      window_size)
from pytorchcv_tpu_torch.models.propainter_rfc import \
    calc_bidirectional_opt_flow_completion_by_pprfc as port_calc
from pytorchcv_tpu_torch.models.propainter_rfc_stream import \
    ProPainterRFCSequencer
from pytorchcv_tpu_torch.nn.deform import deform_conv2d
from pytorchcv_tpu_torch.streaming import engine as peng
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_SIZE = (112, 136)


def _nchw(a):
    """NHWC (or N..HWC) numpy -> torch with the channel axis second."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().to(torch.float32).numpy(), 1, -1)


def _bounded_inputs(rs, h, w, c, g, rb, center_std):
    """x, offset = center + U(-rb, rb), mask, center: NHWC numpy, as the
    JAX package's deform-patch tests draw them."""
    x = rs.randn(1, h, w, c).astype(np.float32)
    center = (rs.randn(1, h, w, 2) * center_std).astype(np.float32)
    resid = rs.uniform(-rb, rb, (1, h, w, g, 9, 2)).astype(np.float32)
    offset = (resid + center[:, :, :, None, None, :]).reshape(
        1, h, w, g * 18)
    mask = rs.rand(1, h, w, g * 9).astype(np.float32)
    return x, offset, mask, center


def _port_samples(x, offset, mask, g, rb, dtype):
    """The port's sampler on CPU tensors (its plain version), as (1, H, W,
    9*C) f32 numpy."""
    h, w, c = x.shape[1:]
    got = deform_sample(_nchw(x).to(dtype), _nchw(offset), _nchw(mask), g,
                        rb)
    assert got.shape == (h * w, 9, c) and got.dtype == dtype
    return got.to(torch.float32).numpy().reshape(1, h, w, 9 * c)


def test_sampler_matches_pallas_kernel_f32():
    rs = np.random.RandomState(0)
    h, w, c, g, rb = 19, 27, 32, 4, 2.5     # N = 513, not a multiple of 80
    x, offset, mask, center = _bounded_inputs(rs, h, w, c, g, rb, 6.0)
    ref = np.asarray(deform_sample_patch(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask), g,
        jnp.asarray(center), rb, window_size(rb), interpret=True))
    got = _port_samples(x, offset, mask, g, rb, torch.float32)
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * np.abs(x).max(), err


def test_sampler_matches_pallas_kernel_bf16():
    rs = np.random.RandomState(1)
    h, w, c, g, rb = 16, 24, 16, 2, 3.0
    x, offset, mask, center = _bounded_inputs(rs, h, w, c, g, rb, 4.0)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)  # exact bf16
    ref = np.asarray(deform_sample_patch(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(offset),
        jnp.asarray(mask), g, jnp.asarray(center), rb, window_size(rb),
        interpret=True), np.float32)
    got = _port_samples(x, offset, mask, g, rb, torch.bfloat16)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 0.05


@pytest.mark.parametrize("case", ["contract", "no_center", "batch2",
                                  "stride2", "below_window"])
def test_deform_conv2d_matches_jax_general(case):
    """On the contract (3x3, stride 1, pad 1, batch 1, H and W >= P) the
    port samples through K5's wrapper; off it through its general route.
    Both against JAX ``_deform_general``."""
    rs = np.random.RandomState(2)
    b = 2 if case == "batch2" else 1
    h, w = (9, 11) if case == "below_window" else (17, 20)
    c, g, o, rb = 16, 4, 8, 3.0
    stride, pad = (2, 0) if case == "stride2" else (1, 1)
    ho, wo = (h + 2 * pad - 3) // stride + 1, (w + 2 * pad - 3) // stride + 1
    x = rs.randn(b, h, w, c).astype(np.float32)
    center = (rs.randn(b, ho, wo, 2) * 3.0).astype(np.float32)
    resid = rs.uniform(-rb, rb, (b, ho, wo, g, 9, 2)).astype(np.float32)
    offset = (resid + center[:, :, :, None, None, :]).reshape(
        b, ho, wo, g * 18)
    mask = rs.rand(b, ho, wo, g * 9).astype(np.float32)
    kernel = (rs.randn(3, 3, c, o) * 0.1).astype(np.float32)
    bias = rs.randn(o).astype(np.float32)
    ref = np.asarray(_deform_general(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
        jnp.asarray(kernel), jnp.asarray(bias), stride, pad, g))
    got = deform_conv2d(
        _nchw(x), _nchw(offset), _nchw(mask),
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(bias), stride=stride, padding=pad, deform_groups=g,
        center=None if case == "no_center" else _nchw(center),
        residue_bound=rb)
    err = np.abs(_nhwc(got) - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def _draw(path, leaf, rng):
    """Conv kernels U(+-sqrt(6/fan_in)); biases N(0, 0.1), so their
    mapping matters."""
    if path[-1].key == "kernel":
        bound = np.sqrt(6.0 / np.prod(leaf.shape[:-1]))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
    return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def rfc():
    """The JAX RFC (jitted handle) and the port's on one set of numpy
    weights."""
    jm = ptc.get_model("propainter_rfc", init=False, in_size=_SIZE,
                       calc_edge=True)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map_with_path(
        functools.partial(_draw, rng=rng), jm.shape_variables())
    prop = variables["params"]["hg"]["skip_seq"]["skip4"]["feat_prop_module"]
    for d in ("backward_", "forward_"):
        prop["deform_align"][d]["conv_offset"]["conv4"]["conv"]["kernel"] *= \
            np.float32(0.1)
    tm = pt.get_model("propainter_rfc", in_size=_SIZE, calc_edge=True,
                      device="cpu")
    load_jax_variables(tm, variables)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    return jm, tm


def _prop_params(jm):
    return jm.variables["params"]["hg"]["skip_seq"]["skip4"][
        "feat_prop_module"]


@pytest.mark.parametrize("with_flow", [False, True])
def test_second_order_alignment_matches_jax(rfc, with_flow):
    jm, tm = rfc
    h, w = _SIZE[0] // 8, _SIZE[1] // 8
    rs = np.random.RandomState(3)
    x = rs.randn(1, h, w, 256).astype(np.float32)
    cond = rs.randn(1, h, w, 384).astype(np.float32)
    flow = (rs.randn(1, h, w, 2) * 3.0).astype(np.float32)
    params = _prop_params(jm)["deform_align"]["backward_"]
    mod = jrfc.SecondOrderDeformableAlignment(out_channels=128)
    ref = np.asarray(mod.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(cond),
        jnp.asarray(flow) if with_flow else None))
    align = tm.hg.skip_seq.skip4.feat_prop_module.deform_align["backward_"]
    with torch.no_grad():
        got = _nhwc(align(_nchw(x), _nchw(cond),
                          _nchw(flow) if with_flow else None))
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err


def test_bidirectional_propagation_matches_jax(rfc):
    jm, tm = rfc
    h, w = _SIZE[0] // 8, _SIZE[1] // 8
    x = np.random.RandomState(4).randn(1, 3, h, w, 128).astype(np.float32)
    mod = jrfc.RFCBidirectionalPropagation(channels=128)
    ref = np.asarray(mod.apply({"params": _prop_params(jm)},
                               jnp.asarray(x)))
    with torch.no_grad():
        got = tm.hg.skip_seq.skip4.feat_prop_module(
            torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()))
    got = got.permute(0, 1, 3, 4, 2).numpy()
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err


def _clip(seed, t, size=_SIZE):
    """Flows (t, H, W, 4) of a few pixels and flow masks (t, H, W, 2)."""
    rs = np.random.RandomState(seed)
    flows = (rs.randn(t, *size, 4) * 3.0).astype(np.float32)
    masks = (rs.rand(t, *size, 2) > 0.8).astype(np.float32)
    return flows, masks


def test_whole_model_matches_jax(rfc):
    """``calc_bidirectional_opt_flow_completion_by_pprfc`` at T = 3."""
    jm, tm = rfc
    flows, masks = _clip(5, 3)
    ref_f, ref_e = jrfc.calc_bidirectional_opt_flow_completion_by_pprfc(
        jm, jnp.asarray(flows), jnp.asarray(masks))
    with torch.no_grad():
        got_f, got_e = port_calc(tm, _nchw(flows), _nchw(masks))
    assert got_f.shape == (3, 4, *_SIZE) and got_e.shape == (3, 2, *_SIZE)
    ref_f = np.asarray(ref_f)
    tol = 1e-4 * np.abs(ref_f).max()
    assert np.abs(_nhwc(got_f) - ref_f).max() <= tol
    assert np.abs(_nhwc(got_e) - np.asarray(ref_e)).max() <= tol


def test_sequencer_matches_jax(rfc):
    """Seven frames, window 4, padding 1: two windows of 5 and 3 flows, on
    device buffers and on host buffers."""
    jm, tm = rfc
    flows, masks = _clip(6, 7)
    flows = flows[:6]
    masks = masks[..., :1]
    ref = np.asarray(JaxSequencer(jnp.asarray(flows), jnp.asarray(masks),
                                  pprfc_model=jm, window_size=4,
                                  padding=1)[0:6])
    seq = ProPainterRFCSequencer(_nchw(flows), _nchw(masks),
                                 pprfc_model=tm, window_size=4, padding=1)
    assert [repr(m) for m in seq.window_index] == ["0:4:0 <- 0:5/0:6",
                                                   "4:7:1 <- 3:6/3:7"]
    got = seq[0:6]
    assert got.shape == (6, 4, *_SIZE)
    assert np.abs(_nhwc(got) - ref).max() <= 1e-4 * np.abs(ref).max()
    # host buffers: numpy sources and results, the same windows
    host = ProPainterRFCSequencer(_nchw(flows), _nchw(masks),
                                  pprfc_model=tm, window_size=4, padding=1,
                                  host_buffers=True)[0:6]
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, got.numpy())


def _ranges(index):
    out = []
    for m in index:
        srcs = m.sources if hasattr(m, "sources") else [m.source]
        out.append(((m.target.start, m.target.stop),
                    [(s.start, s.stop) for s in srcs], m.target_start))
    return out


def _both(fn_name, **kw):
    """The JAX and the port function on the same arguments: their windows,
    or the exception type both raise."""
    res = []
    for mod in (jeng, peng):
        try:
            res.append(_ranges(getattr(mod, fn_name)(**kw)))
        except AssertionError:
            res.append(AssertionError)
    return res


def test_window_indices_match_jax():
    pads = [(0, 0), (1, 1), (2, 3), (0, 2), (5, 6)]
    for length, win, pad, mode, extra in itertools.product(
            range(1, 13), range(1, 6), pads, ("ignore", "trim"), (0, 1)):
        j, p = _both("calc_serial_window_sequencer_index", length=length,
                     target_length=length + extra, window_size=win,
                     padding=pad, edge_mode=mode)
        assert j == p, (length, win, pad, mode, extra)
    for length, stride, sp, pad in itertools.product(
            range(1, 13), range(1, 5), pads, pads):
        j, p = _both("calc_sliding_window_sequencer_index", length=length,
                     stride=stride, src_padding=sp, padding=pad)
        assert j == p, (length, stride, sp, pad)
    for length in range(2, 30):
        j, p = (_ranges(mod.concat_window_sequencer_indices([
            mod.calc_serial_window_sequencer_index(length - 1, length, 4,
                                                   (1, 1)),
            mod.calc_serial_window_sequencer_index(length, length, 4,
                                                   (1, 2))]))
            for mod in (jeng, peng))
        assert j == p, length


def test_buffers_trim_clear_and_host():
    """The buffered engine on a tensor: lazy growth, trimming, clearing
    and host buffers; sharded window batches are refused."""
    data = torch.arange(20.0).reshape(10, 2)
    seq = peng.TensorSequencer(data)
    assert torch.equal(seq[0:4], data[:4]) and seq.end_pos == 4
    assert torch.equal(seq[6], data[6]) and seq.end_pos == 7
    seq.trim_buffer_to(5)
    assert torch.equal(seq[5:7], data[5:7]) and seq.buffer.shape[0] == 2
    seq.clear_buffer()
    assert seq.buffer is None and torch.equal(seq[0:2], data[:2])
    host = peng.TensorSequencer(data, host_buffers=True)
    got = host[2:9]
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, data[2:9].numpy())
    index = peng.calc_serial_window_sequencer_index(10, window_size=4)
    for kw in ({"mesh": object()}, {"window_batch": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            peng.WindowBufferedSequencer(index, data=data, **kw)


def test_sequencer_refuses_data_off_the_model_device(rfc):
    _, tm = rfc
    flows = torch.zeros(3, 4, 16, 16, device="meta")
    masks = torch.zeros(4, 1, 16, 16, device="meta")
    seq = ProPainterRFCSequencer(flows, masks, pprfc_model=tm, window_size=2,
                                 padding=1)
    with pytest.raises(ValueError, match="model on cpu"):
        seq[0:3]
