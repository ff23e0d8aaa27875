"""The port's kernels K1-K3, K9 and K10, through their plain PyTorch
versions (CPU tensors), against the JAX package on the same numpy inputs.

K1 (preprocess) vs ``preprocess_batch`` on its einsum and Pallas
interpret paths, and the band tables K1's kernel reads; K2 (int8 conv + epilogue) bit-exact vs ``_cell``, the
unit tail of ``_forward`` and ``fused_chain_xla_ref``; K3 (serving stem)
vs the planar ``kf`` stem of ``_forward``; K9 (int8 stem) bit-exact vs the
Pallas ``stem_conv7x7_s2`` in interpret mode; K10 (window-sum probe) vs the
probe tool's ``oracle``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchcv_tpu.kernels.fused_bottleneck import fused_chain_xla_ref
from pytorchcv_tpu.kernels.preprocess import preprocess_batch as jax_pre
from pytorchcv_tpu.kernels.preprocess import resize_matrices
from pytorchcv_tpu.quant import resnet_int8 as jq
from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv
from pytorchcv_tpu_torch.kernels.stem import maxpool_i8, stem_conv
from pytorchcv_tpu_torch.kernels.preprocess import (_pil_bilinear_matrix,
                                                    bf16_ulp_distance,
                                                    preprocess_batch,
                                                    resize_bands)
from pytorchcv_tpu_torch.kernels.preprocess import \
    resize_matrices as port_resize_matrices
from pytorchcv_tpu_torch.quant.resnet_int8 import _cell, _f32

torch.set_num_threads(1)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _t(x):
    """numpy/JAX array -> torch tensor with the same dtype (bf16 kept)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_preprocess_matches_jax(out_dtype, layout):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 64, 80, 3), dtype=np.uint8)
    r, c = resize_matrices((64, 80), 32)
    ct = np.ascontiguousarray(c.T)
    out = preprocess_batch(torch.from_numpy(imgs), torch.from_numpy(r),
                           torch.from_numpy(ct),
                           out_dtype=getattr(torch, out_dtype), layout=layout)
    for kw in ({"use_pallas": False}, {"use_pallas": False,
                                       "interpret": True}):
        ref = jax_pre(imgs, jnp.asarray(r), jnp.asarray(ct),
                      out_dtype=getattr(jnp, out_dtype), layout=layout, **kw)
        assert tuple(out.shape) == ref.shape
        if out_dtype == "float32":
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=1e-4, rtol=1e-4)
        else:
            dist = bf16_ulp_distance(out, _t(ref))
            assert int(dist.max()) <= 1, int(dist.max())


def _resize_pair(case):
    """(R, Ct) of the classification crop (ResNet's 256 -> 224 and a 4:3
    frame), the segmentation resize (1024x2048 -> 480x480), the CIFAR
    "direct" resize and a dense random pair with a zero row and column."""
    if case.startswith("crop"):
        hw = (256, 256) if case == "crop" else (375, 500)
        r, c = port_resize_matrices(hw, 224)
    elif case == "segmentation":
        r, c = _pil_bilinear_matrix(1024, 480), _pil_bilinear_matrix(2048,
                                                                    480)
    elif case == "direct":
        r, c = _pil_bilinear_matrix(32, 32), _pil_bilinear_matrix(36, 32)
    else:
        rng = np.random.default_rng(7)
        r, c = rng.random((20, 45), np.float32), rng.random((30, 70),
                                                           np.float32)
        r[3], c[4] = 0.0, 0.0
    return r, np.ascontiguousarray(c.T)


@pytest.mark.parametrize("case", ["crop", "crop-4:3", "segmentation",
                                  "direct", "dense"])
def test_resize_bands_cover_every_nonzero(case):
    """K1 reads only the band tables: rebuilt from them, R and Ct are the
    matrices themselves (every non-zero inside a band, every value in
    place), and no block's rows or columns reach past its span."""
    r, ct = _resize_pair(case)
    bands = resize_bands(r, ct)
    oh, ow = bands.out_hw
    idx = bands.index.numpy()
    assert bands.in_hw == (r.shape[1], ct.shape[0]) and (oh, ow) == (
        r.shape[0], ct.shape[1])
    for m, lo, n, taps, tile, span in (
            (r, idx[:oh], idx[oh:2 * oh], bands.r_taps.numpy(), 8,
             bands.row_span),
            (ct.T, idx[2 * oh:2 * oh + ow], idx[2 * oh + ow:],
             bands.c_taps.numpy().T, 64, bands.col_span)):
        rebuilt = np.zeros_like(m)
        for i in range(m.shape[0]):
            rebuilt[i, lo[i]:lo[i] + n[i]] = taps[i, :n[i]]
            assert not taps[i, n[i]:].any()
        np.testing.assert_array_equal(rebuilt, m)
        for s in range(0, m.shape[0], tile):
            cols = np.nonzero(m[s:s + tile].any(axis=0))[0]
            assert cols.size == 0 or cols[-1] - cols[0] < span
    if case == "dense":
        assert idx[3] == 0 and idx[2 * oh + ow + 4] == 0   # no taps
        assert bands.row_span == 45 and bands.col_span == 70


# ---------------------------------------------------------------- K2

def _mk_cell(rng, cin, cout, k, scale=0.05):
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * scale
    s_w = np.maximum(np.abs(kern).max(axis=(0, 1, 2)), 1e-12) / 127.0
    wq = np.clip(np.round(kern / s_w), -127, 127).astype(np.int8)
    return {"wq": wq,
            "gain": (s_w * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}


def _jax_cell(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _port_cell(c, stride=1):
    return {"wq": torch.from_numpy(np.ascontiguousarray(
                c["wq"].transpose(3, 0, 1, 2))),
            "gain": torch.from_numpy(c["gain"]),
            "bias": torch.from_numpy(c["bias"]), "stride": stride}


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("out", ["int8", "bf16"])
def test_int8_conv_bit_exact_vs_cell(k, stride, out):
    rng = np.random.default_rng(10 * k + stride)
    cell = _mk_cell(rng, 16, 24, k)
    xq = rng.integers(-127, 128, (2, 9, 9, 16), dtype=np.int8)
    s_in, s_out = 2.7, (None if out == "bf16" else 1.9)
    for relu in (True, False):
        ref = jq._cell(jnp.asarray(xq), s_in, _jax_cell(cell), stride, relu,
                       s_out)
        got = _cell(torch.from_numpy(xq), s_in, _port_cell(cell), stride,
                    relu, s_out)
        assert tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), _np(ref))


def test_int8_conv_exact_beyond_f32_integer_range():
    """Sums past 2**24, where an f32 accumulation would round."""
    rng = np.random.default_rng(3)
    cell = _mk_cell(rng, 128, 16, 3)
    cell["wq"] = np.full_like(cell["wq"], 127)
    cell["wq"][0, 0, 0, :] = rng.integers(120, 128, 16)
    xq = rng.integers(125, 128, (1, 6, 6, 128), dtype=np.int8)
    ref = jq._cell(jnp.asarray(xq), 2.0, _jax_cell(cell), 1, False, None)
    got = _cell(torch.from_numpy(xq), 2.0, _port_cell(cell), 1, False, None)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), _np(ref))


@pytest.mark.parametrize("residual", ["i8_bf16", "i8_identity", "bf16"])
@pytest.mark.parametrize("out", ["int8", "bf16"])
def test_int8_conv_unit_tail_bit_exact(residual, out):
    """The bf16-domain unit tail of ``_forward`` (resnet_int8.py:339-365)."""
    rng = np.random.default_rng(7)
    last = _mk_cell(rng, 16, 32, 1)
    t_in = rng.integers(-127, 128, (2, 5, 5, 16), dtype=np.int8)
    res_i8 = rng.integers(-127, 128, (2, 5, 5, 32), dtype=np.int8)
    res_bf = (rng.standard_normal((2, 5, 5, 32)) * 2).astype(np.float32)
    s_last, s_in, s_next = 2.3, 1.7, (None if out == "bf16" else 2.9)
    t = jq._cell(jnp.asarray(t_in), s_last, _jax_cell(last), 1, False)
    if residual == "i8_bf16":
        idf = (jnp.asarray(res_i8).astype(jnp.float32) *
               (s_in / 127.0)).astype(jnp.bfloat16)
        tail = dict(residual=torch.from_numpy(res_i8),
                    res_scale=_f32(s_in / 127.0), round_res=True)
    elif residual == "i8_identity":
        scale = s_next if s_next is not None else s_in
        idf = jnp.asarray(res_i8).astype(jnp.float32) * (scale / 127.0)
        tail = dict(residual=torch.from_numpy(res_i8),
                    res_scale=_f32(scale / 127.0))
    else:
        idf = jnp.asarray(res_bf, jnp.bfloat16)
        tail = dict(residual=_t(idf))
    y = jnp.maximum(t.astype(jnp.float32) + idf.astype(jnp.float32), 0.0)
    ref = y.astype(jnp.bfloat16) if s_next is None else jq._quant(y, s_next)
    pc = _port_cell(last)
    a = pc["gain"] * _f32(s_last / 127.0)
    q = None if s_next is None else _f32(127.0 / s_next)
    got = int8_conv(torch.from_numpy(t_in), pc["wq"], a, pc["bias"], 1,
                    act=None, q=q, **tail)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), _np(ref))


def test_int8_conv_chain_bit_exact_vs_fused_bottleneck_ref():
    """A 2-unit stride-1 bottleneck chain vs ``fused_chain_xla_ref`` (the
    Pallas fused-bottleneck kernel's reference), at its test shapes."""
    rng = np.random.default_rng(0)
    h, w, c, m, n_units, bsz = 4, 8, 128, 128, 2, 2
    units = [{"conv1": _mk_cell(rng, c, m, 1), "conv2": _mk_cell(rng, m, m, 3),
              "conv3": _mk_cell(rng, m, c, 1)} for _ in range(n_units)]
    s_chain = [2.5] + [1.8, 2.1, 2.4] * n_units
    xq = rng.integers(-127, 128, (bsz, h, w, c), dtype=np.int8)
    ref = fused_chain_xla_ref(jnp.asarray(xq),
                              [{k: _jax_cell(v) for k, v in u.items()}
                               for u in units], s_chain, h, w)
    x = torch.from_numpy(xq)
    for u, cells in enumerate(units):
        s_in, s2, s3, s_out = s_chain[3 * u:3 * u + 4]
        t = _cell(x, s_in, _port_cell(cells["conv1"]), 1, True, s2)
        t = _cell(t, s2, _port_cell(cells["conv2"]), 1, True, s3)
        c3 = _port_cell(cells["conv3"])
        x = int8_conv(t, c3["wq"], c3["gain"] * _f32(s3 / 127.0), c3["bias"],
                      1, act=None, q=_f32(127.0 / s_out), residual=x,
                      res_scale=_f32(s_in / 127.0), round_res=True)
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref))


def test_int8_conv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4, 6), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 6), dtype=torch.int8)
    ab = torch.zeros(8)
    with pytest.raises(ValueError, match="multiple of 4"):
        int8_conv(x, w, ab, ab)
    x4 = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="grouped"):
        int8_conv(x4, torch.zeros((8, 3, 3, 4), dtype=torch.int8), ab, ab)
    w8 = torch.zeros((8, 3, 3, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="dilation"):
        int8_conv(x4, w8, ab, ab, dilation=0)
    with pytest.raises(ValueError, match="int8"):
        int8_conv(x4.float(), w8, ab, ab)


# ---------------------------------------------------------------- K3

def test_stem_matches_jax_planar_kf_stem():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 3, 64, 64)) * 1.5, jnp.bfloat16)
    kf = jnp.asarray(rng.standard_normal((7, 7, 3, 64)) * 0.08, jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal(64) * 0.1, jnp.float32)
    s_u1 = 4.0
    # resnet_int8.py:_forward, planar "kf" stem branch.
    y = jax.lax.conv_general_dilated(
        x, kf, (2, 2), [(3, 3), (3, 3)],
        dimension_numbers=("NCHW", "HWIO", "NCHW"),
        preferred_element_type=jnp.float32)
    y = jnp.maximum(y + bias[None, :, None, None], 0.0)
    q = jq._quant(y, s_u1)
    p = jax.lax.reduce_window(q, jnp.int8(-128), jax.lax.max, (1, 1, 3, 3),
                              (1, 1, 2, 2), [(0, 0), (0, 0), (1, 1), (1, 1)])
    ref = np.asarray(jnp.transpose(p, (0, 2, 3, 1))).astype(np.int32)
    got = maxpool_i8(stem_conv(_t(x), _t(kf).permute(2, 0, 1, 3)
                               .contiguous(), _t(bias), _f32(127.0 / s_u1)))
    assert tuple(got.shape) == ref.shape == (2, 16, 16, 64)
    diff = np.abs(got.numpy().astype(np.int32) - ref)
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3, (diff != 0).mean()
    assert (ref > 0).mean() > 0.3          # the test exercises the range


# ---------------------------------------------------------------- K9

def _stem_case():
    """The shapes of tests/test_pallas_kernels.py:139-143."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    k7 = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    gain = (rng.rand(64) + 0.5).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    return x, k7, gain, bias


def test_int8_stem_prepare_bit_equal_to_jax():
    from pytorchcv_tpu.kernels.stem_conv import prepare_stem as jax_prepare
    from pytorchcv_tpu_torch.kernels.stem_conv import prepare_stem
    _, k7, gain, bias = _stem_case()
    wq2, gain_l, _ = (np.asarray(a) for a in
                      jax_prepare(k7, gain, bias, 2.0, 4.0))
    s_w, wq, g = prepare_stem(torch.from_numpy(k7), torch.from_numpy(gain),
                              torch.from_numpy(bias), 2.0, 4.0)
    np.testing.assert_array_equal(
        s_w.numpy(), np.maximum(np.abs(k7).max(axis=(0, 1, 2)), 1e-12) / 127.0)
    np.testing.assert_array_equal(g.numpy(), gain_l[0, :64])
    # the banded matrix's first column block: wq2[a, 3 b + c, o]
    np.testing.assert_array_equal(wq.numpy().reshape(7, 21, 64),
                                  wq2[:, :21, :64])


def test_int8_stem_bit_exact_vs_jax_interpret():
    from pytorchcv_tpu.kernels.stem_conv import stem_conv7x7_s2 as jax_stem
    from pytorchcv_tpu_torch.kernels.stem_conv import stem_conv7x7_s2
    x, k7, gain, bias = _stem_case()
    want = np.asarray(jax_stem(jnp.asarray(x), jnp.asarray(k7),
                               jnp.asarray(gain), jnp.asarray(bias), 2.0, 4.0,
                               interpret=True))
    got = stem_conv7x7_s2(*(torch.from_numpy(a) for a in (x, k7, gain, bias)),
                          2.0, 4.0)
    assert got.dtype == torch.int8 and tuple(got.shape) == (2, 32, 32, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.2
    with pytest.raises(ValueError, match="even H"):
        stem_conv7x7_s2(torch.zeros(1, 63, 64, 3), *(torch.from_numpy(a) for a
                                                     in (k7, gain, bias)),
                        2.0, 4.0)


# ---------------------------------------------------------------- K10

def _probe_tool():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "exp_pallas_patch_probe.py")
    spec = importlib.util.spec_from_file_location("exp_pallas_patch_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_patch_window_sum_matches_the_tool_oracle():
    """The tool's map (60, 128, 128) and start ranges, plus starts outside
    them, which both clamp as the oracle's gather does."""
    from pytorchcv_tpu_torch.kernels.patch_probe import patch_window_sum
    tool = _probe_tool()
    rs = np.random.RandomState(0)
    h, w, c, n = 60, 128, 128, 240
    x = jnp.asarray(rs.randn(h, w, c), jnp.bfloat16)
    starts = np.stack([rs.randint(0, h - tool.P, n),
                       rs.randint(0, w - tool.QW, n)], 1)
    starts[:40] = np.stack([rs.randint(-20, h + 20, 40),
                            rs.randint(-30, w + 30, 40)], 1)
    starts = starts.astype(np.int32)
    want = np.asarray(tool.oracle(x, jnp.asarray(starts)))
    got = patch_window_sum(_t(x), torch.from_numpy(starts))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, c)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
