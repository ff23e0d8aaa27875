"""The port's ProPainter generator slice against the JAX package on the same
weights and the same numpy inputs: K7's plain version against the JAX
``fused_window_attention`` (the Pallas kernel in interpret mode and the XLA
formulation), the wrapper's contract, the modules that hold or feed the
kernels (sparse window attention with both paths selected, one transformer,
soft split and composite, the fusion feed-forward, both branches of the
bidirectional propagation, the image propagation), the whole generator at
96x176 (token grid 8x15, padded to 10x18: 4 windows, a pad on both axes;
hidden 128 in 4 heads of 32, depth 2), and the IP -> IT -> IM sequencer
chain on an 11-frame clip.

Tolerances (f32, ``jax_default_matmul_precision=float32`` from conftest):
attention within 2e-5 of the largest output (the JAX package's own kernel
test); modules, the model and the chain within 1e-4 of the largest output
(summation orders of convs and products, carried through the blocks).

The JAX generator's variables are drawn once (``jax.eval_shape`` of its
init, then seeded numpy draws: no XLA compile of init) and carried into the
port by ``load_jax_variables``. Two draws are scaled down:

- the last conv of each ``conv_offset`` to a hundredth of the init's scale
  (the reference zero-initializes it). On random weights the propagation's
  recurrence is chaotic, as in the RFC test: at a tenth, the JAX package's
  own jitted and op-by-op runs drift apart by 1.9e-3 at the last frame of
  an 11-local-frame window (20 recurrent steps, the backward pass then the
  forward one), and the port lies as far from either; at a hundredth they
  agree within 5e-6 on every frame. The offsets still move each sample by
  the flow, a few pixels.
- the last decoder conv to a hundredth, so that the output tanh stays off
  its saturation, where it would hide differences.

Flows are smooth (sums of low-frequency sinusoids, a few pixels), so that
warps stay on the image and the consistency check passes where it should.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.kernels.attention import \
    fused_window_attention as jax_attention
from pytorchcv_tpu.models import propainter as jpp
from pytorchcv_tpu.models import propainter_ip as jip
from pytorchcv_tpu.models.propainter_stream import (
    ProPainterIMSequencer as JaxIM, ProPainterIPSequencer as JaxIP,
    ProPainterITSequencer as JaxIT)
from pytorchcv_tpu.streaming import TensorSequencer as JaxTensorSequencer
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels import LAUNCHES
from pytorchcv_tpu_torch.kernels.attention import (
    fused_window_attention, fused_window_attention_reference)
from pytorchcv_tpu_torch.models.propainter_stream import (
    ProPainterIMSequencer, ProPainterIPSequencer, ProPainterITSequencer)
from pytorchcv_tpu_torch.streaming import TensorSequencer
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_SIZE = (96, 176)
_CFG = dict(hidden_dim=128, depth=2, in_size=_SIZE)
_LOCAL = (24, 44)              # the encoder's 1/4 map
_TOKENS = (8, 15)              # soft split's token grid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _cf(a):
    """(..., H, W, C) numpy -> torch (..., C, H, W)."""
    return _t(np.moveaxis(np.asarray(a, np.float32), -1, -3))


def _cl(t):
    """torch (..., C, H, W) -> numpy (..., H, W, C)."""
    return np.moveaxis(t.detach().to(torch.float32).numpy(), -3, -1)


def _close(got, ref, rtol=1e-4):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, np.abs(ref).max())


@pytest.mark.parametrize("route", ["interpret", "xla"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [16, 32, 128])
def test_attention_plain_matches_jax(d, masked, route):
    """K7's plain version (the wrapper on CPU tensors) at Lq 45, Lk 90 (the
    window's tokens and two frames' worth), a mask of 0 and -1e9."""
    rs = np.random.RandomState(d)
    q, k, v = (rs.randn(2, 3, n, d).astype(np.float32)
               for n in (45, 90, 90))
    mask = np.where(rs.rand(2, 3, 45, 90) > 0.5, 0.0, -1e9).astype(
        np.float32) if masked else None
    scale = d ** -0.5
    ref = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        mask=None if mask is None else jnp.asarray(mask), use_pallas=False,
        interpret=route == "interpret"))
    before = dict(LAUNCHES)
    got = fused_window_attention(_t(q), _t(k), _t(v), scale,
                                 None if mask is None else _t(mask))
    assert LAUNCHES == before
    assert got.shape == (2, 3, 45, d) and got.dtype == torch.float32
    _close(got.numpy(), ref, 2e-5)


def _tf32(x):
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: half of the dropped 13 bits' range added
    to the magnitude, then the 13 bits masked."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as K7's mma.sync products: k-steps of 8, each three TF32
    products (x = hi + lo, lo = tf32(x - hi)), the small ones a_lo b_hi +
    a_hi b_lo summed apart from a_hi b_hi, in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    big = torch.zeros(a.shape[:-1] + b.shape[-1:])
    small = torch.zeros_like(big)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        small = small + al[..., ks] @ bh[..., ks, :]
        small = small + ah[..., ks] @ bl[..., ks, :]
        big = big + ah[..., ks] @ bh[..., ks, :]
    return big + small


def _k7_design(q, k, v, scale, mask=None, tile=32):
    """K7's f32 design in torch: the head columns of q k^T permuted as the
    kernel's fragments take them (k-step 2i: 16i + 4t, then 16i + 4t + 1;
    k-step 2i + 1: + 2, + 3), the online softmax over 32-key tiles in base
    2 (running max from -1e30), p v with each 8 keys in the order (0, 2, 4,
    6, 1, 3, 5, 7) of the A fragment's columns, both products in 3xTF32."""
    d, lk = q.shape[-1], k.shape[-2]
    dp = [16 * (j // 16) + 4 * (j % 4) + 2 * ((j // 8) % 2) + (j % 8) // 4
          for j in range(d)]
    kp = [8 * (j // 8) + 2 * (j % 4) + (j % 8) // 4 for j in range(tile)]
    pad = -lk % tile
    kz = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vz = torch.nn.functional.pad(v, (0, 0, 0, pad))
    s_all = _mm3(q[..., dp], kz[..., dp].transpose(-1, -2))
    log2e = float(np.float32(1.4426950408889634))
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    den = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, lk, tile):
        s = s_all[..., k0:k0 + tile]
        if mask is None:
            s = s * float(np.float32(scale) * np.float32(log2e))
        else:
            mk = torch.nn.functional.pad(mask, (0, pad))[..., k0:k0 + tile]
            s = (s * float(np.float32(scale)) + mk) * log2e
        keys = torch.arange(k0, k0 + tile)
        s = torch.where(keys < lk, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        vt = vz[..., k0:k0 + tile, :]
        acc = torch.addcmul(_mm3(p[..., kp], vt[..., kp, :]), acc, alpha)
        m = m_new
    return acc / den


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                 # a TF32 value; its ulp 2^-10
    x = torch.tensor([one, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -20])
    want = [one, one, 1.0 + 2.0 ** -9, -one, 1.0]
    assert _tf32(x).tolist() == want


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_tf32x3_design_within_gate(masked):
    """K7's 3xTF32 tensor-core design against the plain version at D 128,
    Lq 70, a ragged Lk 150 (five 32-key tiles, the last 22 keys), with and
    without a mask of 0 and -1e9: within 2e-5 of max |plain|, the kernel's
    gate on the card. A single TF32 product misses that gate."""
    rs = np.random.RandomState(5)
    q, k, v = (_t(rs.randn(2, n, 128)) for n in (70, 150, 150))
    mask = _t(np.where(rs.rand(2, 70, 150) > 0.5, 0.0, -1e9)) \
        if masked else None
    scale = 128 ** -0.5
    ref = fused_window_attention(q, k, v, scale, mask)
    got = _k7_design(q, k, v, scale, mask)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 2e-5, err
    one = torch.softmax(_tf32(q) @ _tf32(k).transpose(-1, -2) * scale + (
        0 if mask is None else mask), -1) @ _tf32(v)
    assert float((one - ref).abs().max() / ref.abs().max()) > 2e-5


def test_attention_wrapper_contract():
    """Default scale D ** -0.5; a mask broadcast from (Lq, Lk); bf16 out in
    q's type; D > 128, mismatched shapes or dtypes and calls autograd would
    record raise."""
    rs = np.random.RandomState(7)
    q, k, v = (_t(rs.randn(5, n, 8)) for n in (3, 7, 7))
    mask = _t(np.where(rs.rand(3, 7) > 0.3, 0.0, -1e9))
    got = fused_window_attention(q, k, v, mask=mask)
    ref = fused_window_attention_reference(q, k, v, 8 ** -0.5,
                                           mask.expand(5, 3, 7))
    assert torch.equal(got, ref)
    bf = fused_window_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert bf.dtype == torch.bfloat16
    wide = torch.zeros(1, 4, 129)
    for args in ((wide, wide, wide), (q, k[:, :, :4], v),
                 (q, k.bfloat16(), v), (q, k, v[:, :6])):
        with pytest.raises(ValueError):
            fused_window_attention(*args)
    with pytest.raises(ValueError, match="no backward"):
        fused_window_attention(q.requires_grad_(), k, v)


def _apply(module, variables, *arrays, **static):
    """``module.apply`` jitted (one XLA compile instead of one per
    operation): arrays traced, ``static`` keyword arguments fixed."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **static))
    return np.asarray(fn(variables, *map(jnp.asarray, arrays)))


def _draw(path, leaf, rng):
    """Kernels U(+-sqrt(6/fan_in)); biases and norm scales N(0, 0.1) (a
    norm scale of 1 plus it), so that their mapping matters."""
    if path[-1].key == "kernel":
        bound = np.sqrt(6.0 / np.prod(leaf.shape[:-1]))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
    noise = (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
    return noise + np.float32(path[-1].key == "scale")


def _generators():
    """The JAX generator (jitted handle) and the port's on one set of numpy
    weights."""
    jm = ptc.get_model("propainter", init=False, **_CFG)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map_with_path(
        functools.partial(_draw, rng=rng), jm.shape_variables())
    params = variables["params"]
    for d in ("backward_1", "forward_1"):
        params["feat_prop_module"]["deform_align"][d]["conv_offset"][
            "conv4"]["conv"]["kernel"] *= np.float32(0.01)
    params["decoder"]["unit2"]["conv2"]["conv"]["kernel"] *= np.float32(0.01)
    tm = pt.get_model("propainter", device="cpu", **_CFG)
    load_jax_variables(tm, variables)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    return jm, tm


@pytest.fixture(scope="module")
def gen():
    return _generators()


def _smooth_flows(seed, t, size, amp):
    """(t, H, W, 4) forward and backward flows, each component a sum of
    three low-frequency sinusoids of amplitude up to ``amp`` px."""
    rs = np.random.RandomState(seed)
    h, w = size
    ys = np.linspace(0.0, 1.0, h)[:, None]
    xs = np.linspace(0.0, 1.0, w)[None, :]
    out = np.zeros((t, h, w, 4), np.float32)
    for i in range(t):
        for c in range(4):
            for _ in range(3):
                fy, fx = rs.randint(0, 3, 2)
                out[i, :, :, c] += amp / 3 * rs.rand() * np.sin(
                    6.2832 * (fy * ys + fx * xs) + 6.2832 * rs.rand())
    return out


def _masks(seed, t, size):
    """(t, H, W, 1) masks: an ellipse moving across the frame, ~10 %."""
    h, w = size
    ys = np.linspace(0.0, 1.0, h)[:, None]
    xs = np.linspace(0.0, 1.0, w)[None, :]
    phase = np.random.RandomState(seed).rand() * 6.2832
    out = np.zeros((t, h, w, 1), np.float32)
    for i in range(t):
        cy = 0.5 + 0.25 * np.cos(phase + 6.2832 * i / 16)
        cx = 0.5 + 0.3 * np.sin(phase + 6.2832 * i / 16)
        out[i, ..., 0] = ((xs - cx) / 0.2) ** 2 + ((ys - cy) / 0.16) ** 2 <= 1
    return out


def _win_mask(t):
    """(1, t, 8, 15, 1): window (0, 0) of the padded 10x18 token grid is
    masked in frame 1, the other three windows nowhere."""
    m = np.zeros((1, t, *_TOKENS, 1), np.float32)
    m[0, 1, 2, 3] = 1.0
    return m


def _transformer_params(jm):
    return jm.variables["params"]["transformers"]["transformer"]["0"]


@pytest.mark.parametrize("what", ["attention", "transformer"])
def test_sparse_window_attention_matches_jax(gen, what):
    """Both attention paths are selected (one window masked, three not),
    over frames 0, 2, 4 of 5 on the full path."""
    jm, tm = gen
    t = 5
    x = np.random.RandomState(8).randn(1, t, *_TOKENS, 128).astype(
        np.float32)
    mask = _win_mask(2)
    time_idx = np.arange(0, t, 2)
    params = _transformer_params(jm)
    block = tm.transformers.transformer[0]
    if what == "attention":
        ref = _apply(jpp.SparseWindowAttention(dim=128),
                     {"params": params["attention"]}, x, mask, time_idx)
        with torch.no_grad():
            got = block.attention(_t(x), _t(mask), torch.as_tensor(time_idx))
    else:
        ref = _apply(jpp.TemporalSparseTransformer(dim=128),
                     {"params": params}, x, fold_x_size=_LOCAL, mask=mask,
                     time_idx=time_idx)
        with torch.no_grad():
            got = block(_t(x), _LOCAL, _t(mask), torch.as_tensor(time_idx))
    assert got.shape == x.shape
    _close(got.numpy(), ref)


def test_soft_split_and_comp_match_jax(gen):
    jm, tm = gen
    b, t = 1, 3
    x = np.random.RandomState(9).randn(b * t, *_LOCAL, 128).astype(
        np.float32)
    params = jm.variables["params"]
    tok = _apply(jpp.SoftSplit(hidden_dim=128), {"params": params["ss"]}, x,
                 batch=b, output_size=_LOCAL)
    out = _apply(jpp.SoftComp(channels=128), {"params": params["sc"]}, tok,
                 time=t, output_size=_LOCAL)
    with torch.no_grad():
        got_tok = tm.ss(_cf(x), b)
        got = tm.sc(got_tok, _LOCAL)
    assert got_tok.shape == (b, t, *_TOKENS, 128)
    _close(got_tok.numpy(), tok)
    _close(_cl(got), out)


def test_fusion_feed_forward_matches_jax(gen):
    jm, tm = gen
    n = 2 * _TOKENS[0] * _TOKENS[1]
    x = np.random.RandomState(10).randn(1, n, 128).astype(np.float32)
    ref = _apply(jpp.FusionFeedForward(dim=128),
                 {"params": _transformer_params(jm)["mlp"]}, x,
                 output_size=_LOCAL)
    with torch.no_grad():
        got = tm.transformers.transformer[0].mlp(_t(x), _LOCAL)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("learnable", [True, False])
def test_bidirectional_propagation_matches_jax(gen, learnable):
    """Learnable: the generator's feature propagation on 4 frames of the
    1/4 map (deformable alignment, K5's plain version); not learnable:
    pixels of 5 frames, bilinear warps."""
    jm, tm = gen
    rs = np.random.RandomState(11)
    if learnable:
        t, size, c, m = 4, _LOCAL, 128, 2
        mod = tm.feat_prop_module
        params = {"params": jm.variables["params"]["feat_prop_module"]}
    else:
        t, size, c, m = 5, _SIZE, 3, 1
        mod = pt.get_model("propainter_ip", device="cpu").prop
        params = {}
    x = rs.rand(1, t, *size, c).astype(np.float32)
    flows = _smooth_flows(12, t - 1, size, 3.0)[None]
    mask = (rs.rand(1, t, *size, m) > 0.7).astype(np.float32)
    fn = jax.jit(functools.partial(jip.BidirectionalPropagation(
        channels=c, learnable=learnable).apply, params))
    ref = fn(jnp.asarray(x), jnp.asarray(flows[..., :2]),
             jnp.asarray(flows[..., 2:]), jnp.asarray(mask))
    with torch.no_grad():
        got = mod(_cf(x), _cf(flows[..., :2]), _cf(flows[..., 2:]),
                  _cf(mask))
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            _close(_cl(g), r)


def test_image_propagation_matches_jax():
    """11 frames, the chain test's shape (XLA's compile cache serves
    both)."""
    t = 11
    rs = np.random.RandomState(13)
    frames = rs.rand(t, *_SIZE, 3).astype(np.float32)
    masks = _masks(14, t, _SIZE)
    flows = _smooth_flows(15, t - 1, _SIZE, 4.0)
    jm = ptc.get_model("propainter_ip")
    ref_f, ref_m = jm(jnp.asarray(frames), jnp.asarray(masks),
                      jnp.asarray(flows), interpolation="nearest")
    tm = pt.get_model("propainter_ip", device="cpu")
    with torch.no_grad():
        got_f, got_m = tm(_cf(frames), _cf(masks), _cf(flows))
    _close(_cl(got_f), ref_f)
    np.testing.assert_array_equal(_cl(got_m), np.asarray(ref_m))
    assert 0 < float(ref_m.sum()) < float(masks.sum())   # it propagated


def _clip(t, seed=16):
    rs = np.random.RandomState(seed)
    frames = rs.rand(t, *_SIZE, 3).astype(np.float32)
    return frames, _masks(seed, t, _SIZE), _smooth_flows(seed, t - 1, _SIZE,
                                                         4.0)


def test_whole_generator_matches_jax(gen):
    """7 frames, 6 of them local (the shape of the chain's first window)."""
    jm, tm = gen
    t, l_t = 7, 6
    frames, masks, flows = _clip(t, seed=17)
    updated = _masks(18, t, _SIZE)
    masked = frames * (1 - masks)
    ref = np.asarray(jm(masked[None], updated[None], masks[None],
                        flows[None, :l_t - 1], l_t))
    with torch.no_grad():
        got = tm(_cf(masked[None]), _cf(updated[None]), _cf(masks[None]),
                 _cf(flows[None, :l_t - 1]), l_t)
    assert got.shape == (1, l_t, 3, *_SIZE)
    assert float(np.abs(ref).max()) < 0.99        # tanh not saturated
    _close(_cl(got), ref)


def test_sequencer_chain_matches_jax(gen):
    """IP (one window of 80, padding 10) -> IT (overlapping stride-5
    windows at 0, 5, 10: 7, 11 and 7 frames, 6, 11 and 6 of them local,
    the first and the last with a reference frame) -> IM. Eleven frames
    give two window shapes, one of them the whole-generator test's, so the
    JAX side compiles the generator once more, not twice."""
    jm, tm = gen
    t = 11
    frames, masks, flows = _clip(t)
    ref = JaxIM(JaxIT(JaxIP(jnp.asarray(frames), jnp.asarray(masks),
                            JaxTensorSequencer(jnp.asarray(flows))),
                      jnp.asarray(masks),
                      JaxTensorSequencer(jnp.asarray(flows)), pp_model=jm),
                jnp.asarray(frames), jnp.asarray(masks))[0:t]
    f, m = _cf(frames), _cf(masks)
    comp = TensorSequencer(_cf(flows))
    it = ProPainterITSequencer(
        ProPainterIPSequencer(f, m, comp, device="cpu"), m, comp,
        pp_model=tm)
    assert [repr(w) for w in it.window_index] == [
        "0:6:0 <- 0:11/0:11/0:5", "0:11:0 <- 0:11/0:11/0:10",
        "5:11:0 <- 0:11/0:11/5:10"]
    got = ProPainterIMSequencer(it, f, m)[0:t]
    assert got.shape == (t, 3, *_SIZE)
    _close(_cl(got), ref)
    known = (m == 0).expand_as(f)
    assert torch.equal(got[known], f[known])
