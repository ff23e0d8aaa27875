"""CPU checks of the designs of K5 (deformable sampling,
``csrc/deform_sample.cu``) and K9 (the int8 7x7 stem, ``csrc/stem_int8.cu``),
which only run on the card:

* K9's tensor-core K order (``stem_k_layout``: kernel rows of 8 taps of 4
  channels, the pads zero) and window layout (planes of even and odd input
  columns, the odd one at bank 16), emulated in torch as an int64 product
  per tile and the kernel's epilogue, are bit-equal to
  ``stem_conv7x7_s2_reference`` at O 64, 32 and 8, and to the JAX function
  in interpret mode; its plan fits shared memory;
* K9 quantizes the weights it is given on every call: on its card route
  (the launch replaced by the plain product of the operands it is
  handed) a write through ``.data`` and a change to an inference tensor
  show in the next call, and the prepared entry is bit-equal to the
  one-shot entry;
* K5's walk of tiles of pixels x taps x channel vectors (the kernel's
  index arithmetic, steps and carries included) writes every output
  element exactly once, with ragged last tiles, vectors narrowed by C/G
  and more groups than a tile stages; its transpose tiles cover x once;
* K5's vector width is the widest that divides C/G and fits the source's
  alignment, and its plan stages the most pixels whose samples fit;
* K5's plain version, x NCHW or channels-last, is bit-equal to its
  function written out in numpy from the contract;
* K9's K order takes every tap once and its plan is the cheapest fit;
* both wrappers refuse every call outside their contracts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorchcv_tpu_torch.kernels import deform_patch as k5
from pytorchcv_tpu_torch.kernels import stem_conv as k9
from pytorchcv_tpu_torch.kernels._build import f32

torch.set_num_threads(1)

_SMEM_MAX = 232_448


# ---------------------------------------------------------------- K9

def _k9_emulated(x, k7, gain, bias, s_img, s_out, rows):
    """K9 as the kernel computes it: per tile of ``rows`` output rows, the
    window quantized into words (4 channels, the 4th zero) at the kernel's
    (plane, row, word) addresses, A gathered by each pixel's base and each
    tap's offset, an exact int64 product with B in ``stem_k_layout``'s
    order, then the epilogue's f32 steps, each rounded on its own."""
    b, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    o = k7.shape[3]
    _, wq, g = k9.prepare_stem(k7, gain, bias, s_img, s_out)
    layout = k9.stem_k_layout()
    assert len(layout) == 224
    bmat = torch.zeros(224, o, dtype=torch.int64)
    for k, tap in enumerate(layout):
        if tap is not None:
            bmat[k] = wq[tap].to(torch.int64)
    xq = torch.clamp(torch.round(x * f32(127.0 / s_img)), -127, 127)
    rows_in, hp, po = k9.window_geometry(rows, wo)
    assert po % 32 == 16 and po >= rows_in * hp
    out = torch.empty(b, ho, wo, o, dtype=torch.int8)
    ohl, ow = np.divmod(np.arange(rows * wo), wo)
    for img in range(b):
        for oh0 in range(0, ho, rows):
            win = torch.zeros(po + rows_in * hp, 4, dtype=torch.int64)
            row, cc = np.divmod(np.arange(rows_in * 2 * hp), 2 * hp)
            ih, iw = 2 * oh0 - 3 + row, cc - 3
            inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
            words = (cc & 1) * po + row * hp + (cc >> 1)
            assert len(set(words.tolist())) == len(words)
            win[words[inside], :3] = xq[img, ih[inside], iw[inside]].to(
                torch.int64)
            n = min(rows, ho - oh0) * wo
            base = 2 * ohl[:n] * hp + ow[:n]
            taps = [(r, s) for r in range(7) for s in range(8)]
            koff = np.array([r * hp + (s & 1) * po + (s >> 1)
                             for r, s in taps])
            a = win[base[:, None] + koff[None, :]].reshape(n, 224)
            acc = a @ bmat
            assert int(acc.abs().max()) < 2 ** 31
            v = torch.clamp_min(acc.to(torch.float32) * g + bias, 0.0)
            q = torch.clamp(torch.round(v * f32(127.0 / s_out)), -127, 127)
            out[img, oh0:oh0 + n // wo] = q.to(torch.int8).view(
                n // wo, wo, o)
    return out


def _k9_case(b, h, w, o, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, 3), generator=g) * 1.5
    k7 = torch.randn((7, 7, 3, o), generator=g) * 0.1
    gain = torch.rand(o, generator=g) + 0.5
    bias = torch.randn(o, generator=g) * 0.1
    return x, k7, gain, bias


@pytest.mark.parametrize("o,b,h,w,rows", [(64, 2, 30, 46, 4),
                                          (32, 1, 22, 34, 3),
                                          (8, 1, 18, 20, 9)])
def test_k9_tensor_core_layout_bit_equal_to_plain(o, b, h, w, rows):
    """Ragged last tiles (15 rows in tiles of 4, 11 in 3), one tile of all
    rows, O 64, 32 and 8."""
    args = (*_k9_case(b, h, w, o, o), 3.0, 2.0)
    got = _k9_emulated(*args, rows)
    ref = k9.stem_conv7x7_s2_reference(*args)
    assert torch.equal(got, ref)
    assert float((ref > 0).float().mean()) > 0.2


def test_k9_tensor_core_layout_bit_equal_to_jax_interpret():
    from pytorchcv_tpu.kernels.stem_conv import stem_conv7x7_s2 as jax_stem
    rng = np.random.RandomState(1)
    x = rng.rand(1, 32, 32, 3).astype(np.float32)
    k7 = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    gain = (rng.rand(64) + 0.5).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    want = np.asarray(jax_stem(jnp.asarray(x), jnp.asarray(k7),
                               jnp.asarray(gain), jnp.asarray(bias), 2.0, 4.0,
                               interpret=True))
    got = _k9_emulated(*(torch.from_numpy(a) for a in (x, k7, gain, bias)),
                       2.0, 4.0, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.2


@pytest.mark.parametrize("b,h,w", [(128, 224, 224), (3, 224, 224),
                                   (3, 70, 46), (1, 480, 640)])
def test_k9_plan_fits_two_blocks_an_sm(b, h, w):
    rows = k9.stem_int8_plan(b, h, w)
    assert 1 <= rows <= min(h // 2, 32)
    assert k9.stem_int8_smem(rows, w // 2) <= k9._SMEM_TWO <= _SMEM_MAX // 2


def _k9_card_route(monkeypatch):
    """K9's card route on the CPU: the wrapper takes its CUDA branch, and
    the launch computes the plain product of the operands it is handed
    (the prepared weights and gain), so stale prepared weights would
    show."""
    from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv_reference

    def launch(x, wq, g, bias, s_img, s_out, rows):
        xq = torch.clamp(torch.round(x * f32(127.0 / s_img)), -127,
                         127).to(torch.int8)
        return int8_conv_reference(xq, wq.permute(3, 0, 1, 2), g, bias,
                                   stride=2, relu=True, q=f32(127.0 / s_out))
    monkeypatch.setattr(k9, "require_cuda_or_cpu", lambda *a: True)
    monkeypatch.setattr(k9, "_launch", launch)


@pytest.mark.parametrize("write", ["mul_", "setitem"])
def test_k9_follows_writes_through_data(monkeypatch, write):
    """A write through ``.data`` bumps no version counter; the next call
    on the card route still gives the plain result of the new weights,
    as the JAX function, which quantizes the weights it is given on every
    call."""
    _k9_card_route(monkeypatch)
    x, k7, gain, bias = _k9_case(1, 8, 8, 16, 5)
    first = k9.stem_conv7x7_s2(x, k7, gain, bias, 3.0, 2.0)
    assert torch.equal(first, k9.stem_conv7x7_s2_reference(
        x, k7, gain, bias, 3.0, 2.0))
    if write == "mul_":
        k7.data.mul_(2.0)
    else:
        k7.data[0, 0, 0, 0] = 100.0
    got = k9.stem_conv7x7_s2(x, k7, gain, bias, 3.0, 2.0)
    assert torch.equal(got, k9.stem_conv7x7_s2_reference(
        x, k7, gain, bias, 3.0, 2.0))
    assert not torch.equal(got, first)


@pytest.mark.parametrize("route", ["cpu", "card"])
def test_k9_prepared_entry_bit_equal_to_the_one_shot_entry(monkeypatch,
                                                          route):
    """``stem_conv7x7_s2_prepared`` on ``prepare_stem``'s weights gives
    the one-shot entry's result, on the CPU and on the card route; it
    refuses weights that are not int8."""
    if route == "card":
        _k9_card_route(monkeypatch)
    x, k7, gain, bias = _k9_case(2, 12, 10, 24, 6)
    _, wq, g = k9.prepare_stem(k7, gain, bias, 3.0, 2.0)
    got = k9.stem_conv7x7_s2_prepared(x, wq, g, bias, 3.0, 2.0)
    assert torch.equal(got, k9.stem_conv7x7_s2(x, k7, gain, bias, 3.0, 2.0))
    assert float((got > 0).float().mean()) > 0.2
    with pytest.raises(ValueError, match="int8"):
        k9.stem_conv7x7_s2_prepared(x, k7, g, bias, 3.0, 2.0)


def test_k9_inference_mode_weight_gives_the_plain_result(monkeypatch):
    """An inference tensor keeps no version counter: the card route
    prepares it on every call, so a change in place shows."""
    _k9_card_route(monkeypatch)
    x, k7, gain, bias = _k9_case(1, 8, 8, 16, 7)
    with torch.inference_mode():
        k7i = k7.clone()
        before = k9.stem_conv7x7_s2(x, k7i, gain, bias, 3.0, 2.0)
        k7i.mul_(-0.5)
        got = k9.stem_conv7x7_s2(x, k7i, gain, bias, 3.0, 2.0)
        assert torch.equal(got, k9.stem_conv7x7_s2_reference(
            x, k7i, gain, bias, 3.0, 2.0))
    assert not torch.equal(got, before)


# ---------------------------------------------------------------- K5

_THREADS = 256


def _tile_walk(np_, c, g, vec, npix):
    """One tile of K5's sampling loop as the kernel steps it: thread t
    starts at item t (pixel-tap t // NV, vector t % NV) and steps by
    (256 // NV, 256 % NV) with a carry, while its pixel-tap is below 9
    np_. Returns the (pixel, tap, first channel) of every item, and checks
    each vector's group and the staged sample index it reads."""
    cpg = c // g
    nvg, nv = cpg // vec, c // vec
    dv, dpk = _THREADS % nv, _THREADS // nv
    staged = 9 * g * npix <= k5._MAX_SAMPLES
    pk, v = np.arange(_THREADS) // nv, np.arange(_THREADS) % nv
    items = []
    while (pk < np_ * 9).any():
        live = pk < np_ * 9
        p, k = np.divmod(pk[live], 9)
        vv = v[live]
        grp = vv // nvg
        assert ((vv * vec) // cpg == grp).all()
        assert ((vv * vec + vec - 1) // cpg == grp).all()
        if staged:
            assert (pk[live] * g + grp).max() < 9 * g * np_ <= k5._MAX_SAMPLES
        items.append(np.stack([p, k, vv * vec], axis=1))
        v = v + dv
        carry = v >= nv
        v = np.where(carry, v - nv, v)
        pk = pk + dpk + carry
    return np.concatenate(items)


def _k5_walk(h, w, c, g, vec, npix):
    """How often each (pixel, tap, channel) is written by all tiles, the
    last one ragged where npix does not divide H*W."""
    hw = h * w
    flat = []
    for n0 in range(0, hw, npix):
        np_ = min(npix, hw - n0)
        if n0 == 0 or np_ < npix:
            walk = _tile_walk(np_, c, g, vec, npix)
        p, k, c0 = walk.T
        for e in range(vec):
            flat.append(((n0 + p) * 9 + k) * c + c0 + e)
    count = np.bincount(np.concatenate(flat), minlength=hw * 9 * c)
    return count


@pytest.mark.parametrize("h,w,c,g,esize", [
    (30, 54, 256, 16, 4),     # RFC f32: 16-byte vectors
    (30, 54, 256, 16, 2),     # RFC bf16
    (19, 27, 32, 4, 4),       # a ragged last tile
    (14, 15, 36, 4, 4),       # C/G 9: one channel a vector
    (14, 15, 48, 4, 2),       # C/G 12 bf16: 8-byte vectors
    (6, 7, 1200, 300, 4),     # 300 groups: not staged, NV > 256
])
def test_k5_walk_writes_every_output_once(h, w, c, g, esize):
    """At the plan's pixels a tile and at twice as many where the samples
    fit (a cooperative launch's wider tiles)."""
    vec = k5.vector_width(c // g, esize)
    assert (c // g) % vec == 0 and vec * esize <= 16
    npix = k5.deform_plan(h, w, g)
    for n in (npix, 2 * npix):
        if n == npix or 9 * g * n <= k5._MAX_SAMPLES:
            assert (_k5_walk(h, w, c, g, vec, n) == 1).all()


def test_k5_plan_and_vectors_at_the_paths_shapes():
    assert k5.deform_plan(30, 54, 16) == 4       # RFC: 405 tiles
    assert k5.deform_plan(60, 108, 16) == 4      # generator: 1620 tiles
    assert k5.deform_plan(6, 7, 300) == 1        # not staged
    assert [k5.vector_width(16, 4), k5.vector_width(16, 2),
            k5.vector_width(8, 4), k5.vector_width(8, 2)] == [4, 8, 4, 8]
    # a source 4 or 8 bytes off 16-byte alignment narrows the vector
    assert k5.vector_width(16, 4, 4) == 1
    assert k5.vector_width(16, 4, 8) == 2


@pytest.mark.parametrize("c,hw", [(256, 1620), (36, 210), (1200, 42)])
def test_k5_transpose_tiles_cover_x_once(c, hw):
    """The launch's 32 x 32 tiles of (C, H*W), c0 = tile // tp * 32 and p0
    = tile % tp * 32, with ragged edges masked."""
    tp = -(-hw // 32)
    tiles = -(-c // 32) * tp
    count = np.zeros((c, hw), np.int32)
    r, l_ = np.divmod(np.arange(32 * 32), 32)
    for t in range(tiles):
        c0, p0 = t // tp * 32, t % tp * 32
        keep = (c0 + r < c) & (p0 + l_ < hw)
        np.add.at(count, (c0 + r[keep], p0 + l_[keep]), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("h,w,c,g,esize", [
    (60, 108, 128, 16, 4),    # the generator f32
    (60, 108, 128, 16, 2),    # the generator bf16
    (10, 12, 8, 4, 2),        # C/G 2 bf16: 4-byte vectors
    (10, 12, 16, 4, 2),       # C/G 4 bf16: 8-byte vectors
    (9, 13, 24, 4, 4),        # C/G 6 f32: 8-byte vectors
    (9, 9, 16, 16, 4),        # C/G 1: one channel a vector
    (9, 9, 114, 57, 4),       # 57 groups: two pixels a tile
])
def test_k5_walk_covers_more_shapes_once(h, w, c, g, esize):
    vec = k5.vector_width(c // g, esize)
    assert (_k5_walk(h, w, c, g, vec, k5.deform_plan(h, w, g)) == 1).all()


@pytest.mark.parametrize("c,hw", [(128, 6480), (48, 210), (8, 33)])
def test_k5_transpose_tiles_cover_more_maps_once(c, hw):
    test_k5_transpose_tiles_cover_x_once(c, hw)


@pytest.mark.parametrize("esize,misalign", [
    (4, 0), (4, 4), (4, 8), (4, 12),
    (2, 0), (2, 2), (2, 4), (2, 6), (2, 8), (2, 10), (2, 12), (2, 14)])
def test_k5_vector_width_is_the_widest_that_fits(esize, misalign):
    """For every C/G up to 96: the vector divides C/G, is at most 16
    bytes, starts aligned to its own size, and is the widest such."""
    for cg in range(1, 97):
        vec = k5.vector_width(cg, esize, misalign)
        ok = [v for v in (1, 2, 4, 8, 16) if v * esize <= 16 and
              cg % v == 0 and misalign % (v * esize) == 0]
        assert vec == max(ok), (cg, vec, ok)


@pytest.mark.parametrize("g,npix", [(1, 4), (16, 4), (56, 4), (57, 2),
                                    (113, 2), (114, 1), (227, 1), (228, 1),
                                    (300, 1)])
def test_k5_plan_stages_the_most_pixels_that_fit(g, npix):
    """Pixels a tile are the most of 1, 2 and 4 whose 9 G samples fit the
    2048 staged samples; past 227 groups one pixel, not staged."""
    assert k5.deform_plan(30, 54, g) == npix
    assert (9 * g * npix <= k5._MAX_SAMPLES) == (g <= 227)
    if npix < 4:
        assert 9 * g * 2 * npix > k5._MAX_SAMPLES


def _deform_numpy(x, offset, mask, g):
    """K5's function written out in numpy f32 from its contract: the
    (y, x) pair of tap k of group g at channel 2 (9 g + k), positions
    (oy - 1 + k // 3, ox - 1 + k % 3) plus it, corners outside the image
    zero, a lerp along y, then along x, then the mask (rounded to x's
    type), each step rounded on its own. x is f32 (1, C, H, W)."""
    _, c, h, w = x.shape
    cg = c // g
    n = h * w
    oy, ox = np.divmod(np.arange(n), w)
    k = np.arange(9)
    off = offset.reshape(g, 9, 2, n)
    py = ((oy[None, None, :] - 1 + k[None, :, None] // 3).astype(np.float32)
          + off[:, :, 0])                                    # (g, 9, n)
    px = ((ox[None, None, :] - 1 + k[None, :, None] % 3).astype(np.float32)
          + off[:, :, 1])
    y0, x0 = np.floor(py), np.floor(px)
    fy, fx = (py - y0).astype(np.float32), (px - x0).astype(np.float32)
    gy, gx = np.float32(1) - fy, np.float32(1) - fx
    xg = x[0].reshape(g, cg, h, w)

    def corner(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yi = np.clip(yy, 0, h - 1).astype(np.int64)
        xi = np.clip(xx, 0, w - 1).astype(np.int64)
        gi = np.arange(g)[:, None, None]
        v = xg[gi, :, yi, xi]                                # (g, 9, n, cg)
        return np.where(inside[..., None], v, np.float32(0))

    r0 = gy[..., None] * corner(y0, x0) + fy[..., None] * corner(y0 + 1, x0)
    r1 = (gy[..., None] * corner(y0, x0 + 1)
          + fy[..., None] * corner(y0 + 1, x0 + 1))
    s = (gx[..., None] * r0 + fx[..., None] * r1) * \
        mask.reshape(g, 9, n)[..., None]
    return np.ascontiguousarray(s.transpose(2, 1, 0, 3).reshape(n, 9, c))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,g,rb", [(12, 14, 16, 4, 2.0),
                                        (9, 11, 18, 2, 1.5),
                                        (10, 10, 8, 8, 3.0)])
def test_k5_plain_version_is_the_contract_written_out(h, w, c, g, rb, dtype,
                                                      layout):
    """The wrapper on CPU tensors, x NCHW or channels-last, bit-equal to
    the function written out in numpy; centers of 2 pixels' spread move
    samples across every border."""
    rs = np.random.RandomState(h * w + c)
    x = torch.from_numpy(rs.randn(1, c, h, w).astype(np.float32)).to(dtype)
    center = rs.randn(1, 2, h, w).astype(np.float32) * 2.0
    resid = rs.uniform(-rb, rb, (1, g, 9, 2, h, w)).astype(np.float32)
    offset = (resid + center[:, None, None]).reshape(1, 18 * g, h, w)
    mask = rs.rand(1, 9 * g, h, w).astype(np.float32)
    m_rounded = torch.from_numpy(mask).to(dtype).to(torch.float32).numpy()
    want = _deform_numpy(x.to(torch.float32).numpy(), offset, m_rounded, g)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    got = k5.deform_sample(x, torch.from_numpy(offset),
                           torch.from_numpy(mask), g, rb)
    assert got.dtype == dtype and tuple(got.shape) == (h * w, 9, c)
    assert torch.equal(got, torch.from_numpy(want).to(dtype))
    outside = float((want == 0).mean())
    assert 0.0 < outside < 0.5, outside      # some, not most, outside


def _k5_args(**kw):
    a = dict(x=torch.zeros(1, 16, 10, 10), offset=torch.zeros(1, 72, 10, 10),
             mask=torch.zeros(1, 36, 10, 10), g=4, rb=2.0)
    a.update(kw)
    return a


@pytest.mark.parametrize("case", [
    dict(x=torch.zeros(2, 16, 10, 10)),                 # batch 2
    dict(x=torch.zeros(16, 10, 10)),                    # no batch axis
    dict(x=torch.zeros(1, 16, 10, 10, dtype=torch.float16)),
    dict(x=torch.zeros(1, 16, 10, 10, dtype=torch.float64)),
    dict(g=3),                                          # C % G
    dict(g=0),
    dict(x=torch.zeros(1, 16, 7, 10), offset=torch.zeros(1, 72, 7, 10),
         mask=torch.zeros(1, 36, 7, 10)),               # H < P = 8
    dict(x=torch.zeros(1, 16, 10, 7), offset=torch.zeros(1, 72, 10, 7),
         mask=torch.zeros(1, 36, 10, 7)),               # W < P
    dict(offset=torch.zeros(1, 36, 10, 10)),
    dict(mask=torch.zeros(1, 72, 10, 10)),
    dict(x=torch.zeros(1, 16, 10, 10, requires_grad=True)),
], ids=["batch2", "3d", "f16", "f64", "c_mod_g", "g0", "h_small", "w_small",
        "offset_shape", "mask_shape", "autograd"])
def test_k5_refuses_calls_outside_the_contract(case):
    a = _k5_args(**case)
    with pytest.raises(ValueError, match="deform_sample"):
        k5.deform_sample(a["x"], a["offset"], a["mask"], a["g"], a["rb"])


def test_k5_no_grad_call_takes_a_grad_tensor():
    a = _k5_args(x=torch.ones(1, 16, 10, 10, requires_grad=True))
    with torch.no_grad():
        got = k5.deform_sample(a["x"], a["offset"], a["mask"], 4, 2.0)
    assert tuple(got.shape) == (100, 9, 16) and not got.requires_grad


# ------------------------------------------------------------ K9, more

@pytest.mark.parametrize("o,b,h,w", [(16, 1, 28, 36), (24, 1, 20, 18),
                                     (40, 2, 14, 30), (48, 1, 12, 12),
                                     (56, 1, 26, 10), (64, 1, 34, 22)])
def test_k9_layout_bit_equal_to_plain_at_the_plans_rows(o, b, h, w):
    """The tensor-core layout at the rows a tile the plan picks, at the O
    no earlier case takes."""
    rows = k9.stem_int8_plan(b, h, w)
    args = (*_k9_case(b, h, w, o, o + h), 2.5, 3.0)
    assert torch.equal(_k9_emulated(*args, rows),
                       k9.stem_conv7x7_s2_reference(*args))


def test_k9_k_layout_takes_every_tap_once():
    """Each kernel row r is one 32-entry K step: taps (r, s, c) for s < 7
    and c < 3 once each, in s-major order, the rest (s 7, c 3) zero."""
    layout = k9.stem_k_layout()
    taps = [t for t in layout if t is not None]
    assert len(taps) == len(set(taps)) == 147
    assert set(taps) == {(r, s, c) for r in range(7) for s in range(7)
                         for c in range(3)}
    for r in range(7):
        step = layout[32 * r:32 * r + 32]
        assert [t for t in step if t is not None] == [
            (r, s, c) for s in range(7) for c in range(3)]
        assert all(t is None for t in step[28:])       # s = 7
        assert all(step[4 * s + 3] is None for s in range(8))


_K9_SHAPES = [(128, 224, 224), (3, 224, 224), (3, 70, 46), (1, 480, 640),
              (1, 224, 224), (8, 224, 224), (32, 224, 224), (64, 320, 320),
              (2, 512, 1024), (4, 32, 32)]


@pytest.mark.parametrize("b,h,w", _K9_SHAPES[4:])
def test_k9_plan_fits_two_blocks_an_sm_at_more_shapes(b, h, w):
    test_k9_plan_fits_two_blocks_an_sm(b, h, w)


@pytest.mark.parametrize("b,h,w", _K9_SHAPES)
def test_k9_plan_is_the_cheapest_fit(b, h, w):
    """Of the rows that fit, none costs less, and of equal cost the plan
    takes the most rows."""
    rows = k9.stem_int8_plan(b, h, w)
    ho, wo = h // 2, w // 2
    cost = k9._plan_cost(b, ho, wo, rows)
    for r in range(1, min(ho, 32) + 1):
        if k9.stem_int8_smem(r, wo) <= k9._SMEM_TWO:
            c = k9._plan_cost(b, ho, wo, r)
            assert c > cost or (c == cost and r <= rows), (r, c, cost)


def test_k9_plan_refuses_an_image_too_wide():
    with pytest.raises(ValueError, match="too|no room"):
        k9.stem_int8_plan(1, 64, 16384)


def _k9_args(**kw):
    a = dict(x=torch.zeros(1, 16, 16, 3), k7=torch.zeros(7, 7, 3, 16),
             gain=torch.ones(16), bias=torch.zeros(16))
    a.update(kw)
    return a


@pytest.mark.parametrize("case", [
    dict(x=torch.zeros(1, 16, 16, 3, dtype=torch.float64)),
    dict(x=torch.zeros(1, 16, 16, 4)),                  # 4 channels
    dict(x=torch.zeros(16, 16, 3)),                     # no batch axis
    dict(x=torch.zeros(1, 15, 16, 3)),                  # odd H
    dict(x=torch.zeros(1, 16, 17, 3)),                  # odd W
    dict(k7=torch.zeros(5, 5, 3, 16)),
    dict(k7=torch.zeros(7, 7, 3, 12), gain=torch.ones(12),
         bias=torch.zeros(12)),                         # O % 8
    dict(k7=torch.zeros(7, 7, 3, 72), gain=torch.ones(72),
         bias=torch.zeros(72)),                         # O > 64
    dict(gain=torch.ones(16, dtype=torch.float64)),
    dict(bias=torch.zeros(8)),
    dict(k7=torch.zeros(7, 7, 3, 16, requires_grad=True)),
], ids=["f64", "c4", "3d", "odd_h", "odd_w", "k5x5", "o12", "o72",
        "gain_f64", "bias_shape", "autograd"])
def test_k9_refuses_calls_outside_the_contract(case):
    a = _k9_args(**case)
    with pytest.raises(ValueError, match="stem_int8"):
        k9.stem_conv7x7_s2(a["x"], a["k7"], a["gain"], a["bias"], 2.0, 4.0)
