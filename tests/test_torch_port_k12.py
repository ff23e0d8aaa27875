"""CPU checks of K12's design (the int8 depthwise 3x3 conv of the int8
MobileNet routes, ``csrc/dwconv_i8.cu``), which runs only on the card:

* its walk emulated in torch, word for word: a thread's strip of V output
  columns (with the 2-column halo) read one 32-bit word (or byte) a
  column and row, the 4x4 byte transpose into channel-major words, the
  3-column window of each channel formed by ``__byte_perm`` or a shift,
  one ``__dp4a`` a kernel row against (w0, w1, w2, 0) from 1.5 * 2^23's
  bits, the last 3 input rows kept and the next 3 (at stride 2, 1)
  iterations' rows loaded ahead down a band of R rows, the epilogue's
  exact float tricks (the activation folded into the clip, whose bounds
  go by the sign of q) and the packed store, is bit-equal to
  ``dwconv_i8_reference`` at every distinct call of ``mobilenetv2_w1``,
  ``mobilenet_w1`` and ``mobilenetv2_w3d4`` (batch 1-3, H and W cut to at
  most 11 and 9), at odd sizes, both strides, every act, q above, at and
  below 0, C 20 and 6, and every instance under forced row bands, and
  writes every output once;
* the plan covers every output of those calls exactly once at batch 128,
  32 and 3 within the kernel's 32-bit thread index;
* a q that is not finite as f32 is refused.
"""

import numpy as np
import pytest
import torch

from pytorchcv_tpu_torch.kernels.dwconv_i8 import (INSTANCES, STRIP,
                                                   K12Plan, call_shapes,
                                                   dwconv_i8,
                                                   dwconv_i8_plan,
                                                   dwconv_i8_reference)

torch.set_num_threads(1)

_MAGIC = 12582912.0           # 1.5 * 2**23
_MAGIC_BITS = 0x4B400000


# -- 32-bit words as 4 byte lanes (uint8 values in int64, low byte first)

def _bp(a, b, sel):
    """__byte_perm(a, b, sel): byte i of the result is byte nibble_i of
    the 8 bytes (a, b)."""
    idx = [(sel >> (4 * i)) & 7 for i in range(4)]
    return torch.cat((a, b), -1)[..., idx]


def _shr8(a):
    return torch.cat((a[..., 1:], torch.zeros_like(a[..., :1])), -1)


def _sbytes(a):
    return torch.where(a >= 128, a - 256, a)


def _dp4a(a, b, acc):
    return acc + (_sbytes(a) * _sbytes(b)).sum(-1)


def _window(row, o):
    """The 3-column window at column o of channel-major words row (..., NW,
    4), as the kernel's ``window<O>``."""
    k, r = divmod(o, 4)
    if r == 0:
        return row[..., k, :]
    if r == 1:
        return _shr8(row[..., k, :])
    return _bp(row[..., k, :], row[..., k + 1, :],
               0x5432 if r == 2 else 0x6543)


def _to_channels(raw, cpt):
    """(T, 4 NW, 4) pixel-major columns -> (T, cpt, NW, 4) channel-major
    words (8 byte permutes a 4x4 block; for one channel 3)."""
    out = []
    for k in range(raw.shape[1] // 4):
        p0, p1, p2, p3 = (raw[:, 4 * k + i] for i in range(4))
        if cpt == 4:
            t0, t1 = _bp(p0, p1, 0x5140), _bp(p0, p1, 0x7362)
            t2, t3 = _bp(p2, p3, 0x5140), _bp(p2, p3, 0x7362)
            out.append(torch.stack((_bp(t0, t2, 0x5410), _bp(t0, t2, 0x7632),
                                    _bp(t1, t3, 0x5410), _bp(t1, t3, 0x7632)),
                                   1))
        else:
            out.append(_bp(_bp(p0, p1, 0x0040), _bp(p2, p3, 0x0040),
                           0x5410)[:, None])
    return torch.stack(out, 2)


def _lanes_of_bits(bits):
    """int32 bit patterns -> (..., 4) byte lanes."""
    u = bits.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(u >> (8 * i)) & 0xFF for i in range(4)], -1)


def emulate(x, w, gain_a, bias_b, q, stride, act, plan: K12Plan):
    """K12 as the kernel computes it under ``plan``; returns (out, writes
    per output)."""
    (cpt, rows), v = plan, STRIP
    bsz, h, wd, c = x.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    ncols = (v - 1) * stride + 3
    nw = (ncols + 3) // 4
    keep = 3 - stride
    strips, bands = -(-wo // v), -(-ho // rows)
    ncw = c // cpt
    t = torch.arange(bsz * bands * strips * ncw)
    cw, rest = t % ncw, t // ncw
    st, rest = rest % strips, rest // strips
    band, b = rest % bands, rest // bands
    c0, ow0 = cw * cpt, st * v
    iw0 = ow0 * stride - 1
    oh0 = band * rows
    oh1 = torch.clamp(oh0 + rows, max=ho)
    xu = x.to(torch.int64) & 0xFF
    wu = w.to(torch.int64) & 0xFF

    def word(img_b, ih, iw, valid):
        """The word (or byte) a thread loads at (ih, iw), zero where not
        valid."""
        ih_, iw_ = ih.clamp(0, h - 1), iw.clamp(0, wd - 1)
        if cpt == 4:
            lanes = torch.stack([xu[img_b, ih_, iw_, c0 + i]
                                 for i in range(4)], -1)
        else:
            lanes = torch.stack([xu[img_b, ih_, iw_, c0]] +
                                [torch.zeros_like(c0)] * 3, -1)
        return torch.where(valid[:, None], lanes, 0)

    def load_row(ih):
        row_ok = (ih >= 0) & (ih < h)
        cols = []
        for i in range(4 * nw):
            iw = iw0 + i
            ok = row_ok & (iw >= 0) & (iw < wd) & torch.tensor(i < ncols)
            cols.append(word(b, ih, iw, ok))
        return torch.stack(cols, 1)                 # (T, 4 NW, 4)

    # weights as dp4a words (w[di][0], w[di][1], w[di][2], 0) a channel
    wrow = []
    for ch in range(cpt):
        per_di = []
        for di in range(3):
            if cpt == 4:
                w0, w1, w2 = (torch.stack([wu[di, dj, c0 + i]
                                           for i in range(4)], -1)
                              for dj in range(3))
                word_ = _bp(_bp(w0, w1, ch | ((ch + 4) << 4)), w2,
                            0x0010 | ((ch + 4) << 8))
                word_ = torch.cat((word_[..., :3],
                                   torch.zeros_like(word_[..., 3:])), -1)
            else:
                word_ = torch.stack([wu[di, dj, c0] for dj in range(3)] +
                                    [torch.zeros_like(c0)], -1)
            per_di.append(word_)
        wrow.append(per_di)
    ga = torch.stack([gain_a[c0 + ch] for ch in range(cpt)], 1)
    bb = torch.stack([bias_b[c0 + ch] for ch in range(cpt)], 1)

    out = torch.zeros((bsz, ho, wo, c), dtype=torch.int64)
    writes = torch.zeros((bsz, ho, wo, c), dtype=torch.int64)
    ih0 = oh0 * stride - 1
    regs = [None, None, None]
    for k in range(keep):
        regs[k] = _to_channels(load_row(ih0 + k), cpt)
    depth = 3 if stride == 1 else 1       # iterations loaded ahead
    ahead = [[load_row(ih0 + d * stride + keep + k) for k in range(stride)]
             for d in range(depth)]
    magic = torch.tensor(_MAGIC, dtype=torch.float32)
    q32 = torch.tensor(q, dtype=torch.float32)
    # the clip's bounds as the host sets them, by act and the sign of q
    six_q = float(torch.tensor(6.0) * q32)
    lo, hi = -127.0, 127.0
    if act and q32 >= 0:
        lo, hi = 0.0, (min(six_q, 127.0) if act == "relu6" else 127.0)
    elif act:
        lo, hi = (max(six_q, -127.0) if act == "relu6" else -127.0), 0.0
    for step in range(rows):
        oh = oh0 + step
        live = oh < oh1
        for k in range(stride):
            regs[keep + k] = _to_channels(ahead[0][k], cpt)
        nxt = (oh + depth < oh1)
        ahead = ahead[1:] + [[torch.where(nxt[:, None, None], load_row(
            (oh + depth) * stride - 1 + keep + k), 0)
            for k in range(stride)]]
        for j in range(v):
            col = live & (ow0 + j < wo)
            e = []
            for ch in range(cpt):
                acc = torch.full_like(t, _MAGIC_BITS)
                for di in range(3):
                    acc = _dp4a(_window(regs[di][:, ch], j * stride),
                                wrow[ch][di], acc)
                val = acc.to(torch.int32).view(torch.float32) - magic
                y = val * ga[:, ch] + bb[:, ch]
                z = torch.clamp(y * q32, lo, hi)
                e.append(_lanes_of_bits((z + magic).view(torch.int32)))
            if cpt == 4:
                packed = _bp(_bp(e[0], e[1], 0x0040),
                             _bp(e[2], e[3], 0x0040), 0x5410)
            else:
                packed = e[0][..., :1]
            sel = col.nonzero()[:, 0]
            ohs, ows = oh[sel], (ow0 + j)[sel]
            for i in range(cpt):
                idx = (b[sel], ohs, ows, c0[sel] + i)
                out.index_put_(idx, packed[sel, i])
                writes.index_put_(idx, torch.ones_like(sel), accumulate=True)
        for k in range(keep):
            regs[k] = regs[k + stride]
    out = torch.where(out >= 128, out - 256, out).to(torch.int8)
    return out, writes


def _operands(rng, shape):
    bsz, h, wd, c = shape
    x = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, c), dtype=np.int8))
    # gains that put sums of 9 taps around +-10 (clipping at 6 and 127)
    a = torch.from_numpy(rng.uniform(2e-4, 1.5e-3, c).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(c) * 2).astype(np.float32))
    return x, w, a, b


def _check(shape, stride, act, plan=None, seed=0, q=9.7):
    rng = np.random.default_rng(seed)
    x, w, a, b = _operands(rng, shape)
    if plan is None:
        plan = dwconv_i8_plan(*shape, stride, 256)
    got, writes = emulate(x, w, a, b, q, stride, act, plan)
    want = dwconv_i8_reference(x, w, a, b, q, stride, act)
    assert bool((writes == 1).all()), (shape, stride, plan)
    assert torch.equal(got, want), (shape, stride, act, plan)
    return plan


_NAMES = ("mobilenetv2_w1", "mobilenet_w1", "mobilenetv2_w3d4")


@pytest.fixture(scope="module")
def every_call():
    """{name: ((B, H, W, C), stride, act) of each K12 call of one forward
    at 224x224, batch 1}."""
    return {n: call_shapes(n) for n in _NAMES}


@pytest.fixture(scope="module")
def path_calls(every_call):
    """{name: its distinct K12 calls}."""
    return {n: sorted(set(calls)) for n, calls in every_call.items()}


def test_call_shapes_match_the_launch_gates(every_call, path_calls):
    assert [len(every_call[n]) for n in _NAMES] == [17, 13, 17]
    assert len(path_calls["mobilenetv2_w1"]) == 10


@pytest.mark.parametrize("name", _NAMES)
def test_emulated_walk_bit_equal_at_every_path_call(name, path_calls):
    """Each distinct call with its C, stride and act, batch 2, H and W cut
    to at most 11 and 9 (7 stays 7), under the plan."""
    for i, ((_, h, wd, c), stride, act) in enumerate(path_calls[name]):
        _check((2, min(h, 11), min(wd, 9), c), stride, act, seed=i)


@pytest.mark.parametrize("q", [9.7, 30.0, 0.0, -3.1, -30.0])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("shape,stride", [
    ((3, 13, 9, 20), 1), ((3, 13, 9, 20), 2), ((1, 5, 11, 6), 1),
    ((3, 7, 7, 6), 2), ((2, 1, 1, 8), 1), ((2, 2, 3, 4), 2)])
def test_emulated_walk_bit_equal_at_odd_shapes(shape, stride, act, q):
    """q 30 puts 6 q above 127 (ReLU6's folded bound is then the clip's);
    below 0 the activation's range folds into the clip mirrored (q -30
    puts 6 q below -127); q 0 gives 0 everywhere."""
    plan = _check(shape, stride, act, seed=shape[3], q=q)
    assert plan.cpt == (1 if shape[3] % 4 else 4)


@pytest.mark.parametrize("cpt,stride", INSTANCES)
def test_every_instance_under_forced_bands(cpt, stride):
    """Every instance of the kernel at C 20 (or 6 for one channel a
    thread), odd H and W, and 1, 2, 3 and all output rows a thread."""
    c = 20 if cpt == 4 else 6
    ho = (13 - 1) // stride + 1
    for rows in (1, 2, 3, ho):
        _check((2, 13, 9 + 2 * STRIP, c), stride, "relu6",
               K12Plan(cpt, rows), seed=rows)


def test_unaligned_pointers_take_one_channel_a_thread():
    assert dwconv_i8_plan(2, 9, 9, 20, 1, 2).cpt == 1
    _check((2, 9, 9, 20), 1, "relu", dwconv_i8_plan(2, 9, 9, 20, 1, 2))


def _covers(n, size, width):
    """``n`` tiles of ``width`` (the last cut at ``size``) cover 0..size-1
    once each."""
    hits = np.zeros(size, np.int64)
    for i in range(n):
        hits[i * width:min((i + 1) * width, size)] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("batch", [128, 32, 3])
def test_plan_covers_every_output_once(batch, path_calls):
    """The thread index (channel word fastest, then strip, band, image)
    is a bijection onto B x bands x strips x C / cpt below 2**31, and the
    bands of rows, strips of v columns and words of cpt channels each
    cover their dimension once."""
    for name in _NAMES:
        for (_, h, wd, c), stride, _ in path_calls[name]:
            plan = dwconv_i8_plan(batch, h, wd, c, stride, 256)
            ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
            bands, strips = -(-ho // plan.rows), -(-wo // STRIP)
            assert c % plan.cpt == 0 and plan.cpt == 4
            assert (plan.cpt, stride) in INSTANCES
            assert batch * bands * strips * (c // plan.cpt) < 2 ** 31
            assert _covers(bands, ho, plan.rows)
            assert _covers(strips, wo, STRIP)
            assert _covers(c // plan.cpt, c, plan.cpt)
            # the band count is what the plan meant: no empty band
            assert (bands - 1) * plan.rows < ho


@pytest.mark.parametrize("q", [float("inf"), float("-inf"), float("nan"),
                               1e39])
def test_q_not_finite_as_f32_is_refused(q):
    """The folded clip needs a finite q; 1e39 overflows f32."""
    x, w, a, b = _operands(np.random.default_rng(0), (1, 5, 5, 8))
    with pytest.raises(ValueError, match="finite"):
        dwconv_i8(x, w, a, b, q, 1, "relu6")
