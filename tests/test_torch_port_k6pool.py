"""CPU checks of the designs of K6 (depthwise conv + folded BN + activation,
``csrc/dwconv.cu``) and ``maxpool_i8`` (``csrc/stem.cu``), which only run
on the card, and of K6's route under ``torch.autocast``:

* K6's plan: the kernel's walk of tiles (whole planes, or bands of rows of
  one plane) and of strips of V outputs writes every output of every
  depthwise call of EfficientNet-B0 and -B0b at 224x224 (batch 128, 32
  and 3) exactly once, within the threads and shared memory a block has;
* K6's staged tile walk emulated in torch (the span read in aligned
  16-byte vectors, scattered into the zero-padded shared layout that
  starts as NaN, stride 2 split by column parity, strips summed in the
  kernel's order, outputs staged at their 16-byte phase) is bit-equal to
  ``dwconv2d_bn_act_reference`` at k 3/5/7, stride 1/2, symmetric and
  TF-SAME pads, odd sizes, f32 and bf16, under the plan and forced plans;
* ``maxpool_i8``'s walk of channel vectors x runs of output rows (the
  kept row max included) writes every output once and is bit-equal to
  ``maxpool_i8_reference`` at C 64, 24 and 3, odd H and W, batch 1;
* a depthwise block and EfficientNet-B0 (64x64) in f32 under bf16
  autocast run K6 on bf16 operands, at cosine >= 0.999 against their
  unfused route under the same autocast (B0: 0.99987 measured); under f16
  autocast they take the unfused route and K6's wrapper is not called.
"""

import numpy as np
import pytest
import torch

import pytorchcv_tpu_torch as pt
import pytorchcv_tpu_torch.nn.conv as conv_mod
from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from pytorchcv_tpu_torch.kernels import dwconv as k6
from pytorchcv_tpu_torch.kernels.stem import (maxpool_i8_reference,
                                              maxpool_plan)
from pytorchcv_tpu_torch.nn import unfused_depthwise
from pytorchcv_tpu_torch.nn.activ import Swish
from pytorchcv_tpu_torch.nn.conv import ConvBlock

torch.set_num_threads(1)

_SMEM_MAX = 232_448


def _out_hw(h, w, k, stride, pad):
    (top, bottom), (left, right) = pad
    return ((h + top + bottom - k) // stride + 1,
            (w + left + right - k) // stride + 1)


@pytest.fixture(scope="module")
def effnet_calls():
    """(C, H, W, k, stride, pad) of each depthwise call of a 224x224
    forward of B0 and of B0b, K6 stubbed to an empty output of its
    shape."""
    calls = {}
    orig = conv_mod.dwconv2d_bn_act
    try:
        for name in ("efficientnet_b0", "efficientnet_b0b"):
            seen = calls.setdefault(name, [])

            def stub(x, w, scale, shift, stride, pad, act, _seen=seen):
                k = w.shape[-1]
                _seen.append((x.shape[1], x.shape[2], x.shape[3], k, stride,
                              pad))
                ho, wo = _out_hw(x.shape[2], x.shape[3], k, stride, pad)
                return x.new_zeros((x.shape[0], x.shape[1], ho, wo))
            conv_mod.dwconv2d_bn_act = stub
            model = pt.get_model(name, device="cpu").eval()
            with torch.inference_mode():
                model(torch.zeros(1, 3, 224, 224))
    finally:
        conv_mod.dwconv2d_bn_act = orig
    return calls


# ---------------------------------------------------------------- K6 plan

def _tiles(n_planes, ho, plan):
    """The kernel's decode of blockIdx.x: (plane0, oy0, planes, rows) of
    every tile, as numpy arrays."""
    bands = -(-ho // plan.rows)
    if bands == 1:
        t = np.arange(-(-n_planes // plan.planes))
        plane0 = t * plan.planes
        return (plane0, np.zeros_like(t),
                np.minimum(plan.planes, n_planes - plane0),
                np.full_like(t, ho))
    t = np.arange(n_planes * bands)
    plane0, band = t // bands, t % bands
    oy0 = band * plan.rows
    return plane0, oy0, np.ones_like(t), np.minimum(plan.rows, ho - oy0)


def _strip_cover(np_, nr, wo, plan):
    """How often the block's threads write each output of a tile of np_
    planes x nr rows: thread t takes strips t, t + threads, ..."""
    spr = -(-wo // plan.v)
    strips = np_ * nr * spr
    i = (np.arange(plan.threads)[None, :] +
         plan.threads * np.arange(-(-strips // plan.threads))[:, None])
    i = i[i < strips]
    pl, rem = i // (nr * spr), i % (nr * spr)
    r, ox0 = rem // spr, (rem % spr) * plan.v
    ox = ox0[:, None] + np.arange(plan.v)[None, :]
    keep = ox < wo
    cover = np.zeros((np_, nr, wo), np.int64)
    np.add.at(cover, (np.broadcast_to(pl[:, None], ox.shape)[keep],
                      np.broadcast_to(r[:, None], ox.shape)[keep], ox[keep]),
              1)
    return cover


@pytest.mark.parametrize("batch", [128, 32, 3])
@pytest.mark.parametrize("name", ["efficientnet_b0", "efficientnet_b0b"])
def test_dwconv_plan_covers_every_output_once(effnet_calls, name, batch):
    calls = effnet_calls[name]
    assert len(calls) == 16
    for c, h, w, k, stride, pad in calls:
        for dtype in (torch.bfloat16, torch.float32):
            plan = k6.dwconv_plan(batch, c, h, w, k, stride, pad, dtype)
            ho, wo = _out_hw(h, w, k, stride, pad)
            assert plan.rows == ho or plan.planes == 1, plan
            assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
            es = 2 if dtype == torch.bfloat16 else 4
            g = k6.tile_geometry(h, w, ho, wo, k, stride, plan.v,
                                 plan.planes, plan.rows, es)
            assert g.smem <= _SMEM_MAX
            strips = plan.planes * plan.rows * g.spr
            assert -(-strips // plan.threads) <= k6._MAX_ROUNDS
            # the tiles' output rows (plane * Ho + oy) tile the map once
            plane0, oy0, nps, nrs = _tiles(batch * c, ho, plan)
            start = plane0 * ho + oy0
            assert start[0] == 0 and np.all(start[1:] == (start + nps * nrs)
                                            [:-1])
            assert start[-1] + nps[-1] * nrs[-1] == batch * c * ho
            # within each kind of tile every output once
            for np_, nr in set(zip(nps.tolist(), nrs.tolist())):
                assert np.all(_strip_cover(np_, nr, wo, plan) == 1)


def test_dwconv_plan_is_cached_and_refuses_a_row_too_wide():
    pad = ((1, 1), (1, 1))
    a = k6.dwconv_plan(128, 32, 112, 112, 3, 1, pad, torch.bfloat16)
    assert k6.dwconv_plan(128, 32, 112, 112, 3, 1, pad,
                          torch.bfloat16) is a
    with pytest.raises(ValueError, match="no room"):
        k6.dwconv_plan(1, 1, 3, 200_000, 7, 1, ((3, 3), (3, 3)),
                       torch.float32)


# ---------------------------------------------------------- K6 emulation

def _emulate(x, w, scale, shift, stride, pad, act, plan, phase_bytes=0):
    """K6's walk, tile by tile, in torch: the input span read as aligned
    16-byte vectors (x's element 0 at ``phase_bytes`` past a 16-byte
    boundary), scattered into the shared layout (NaN where nothing is
    written), the strips' sums in the kernel's order, the affine, and the
    outputs written through the span's head, 16-byte body and tail. The
    activation and the cast apply to the assembled map: torch's CPU
    ``exp`` rounds by vector path, so sigmoid and swish on a tile's strips
    could differ in the last bit from the same values in the plain
    version's map shape."""
    n, c, h, wd = x.shape
    k = w.shape[-1]
    (top, _), (left, _) = pad
    ho, wo = _out_hw(h, wd, k, stride, pad)
    es = x.element_size()
    e16 = 16 // es
    g = k6.tile_geometry(h, wd, ho, wo, k, stride, plan.v, plan.planes,
                         plan.rows, es)
    pw = g.row_pitch
    flat = x.reshape(-1)
    wf = w.to(torch.float32).reshape(c, k * k)
    out = torch.full((n * c * ho * wo,), float("nan"))
    written = torch.zeros(n * c * ho * wo, dtype=torch.int64)
    v = plan.v

    def col(pc):
        return pc if stride == 1 else (pc & 1) * g.half + (pc >> 1)
    for plane0, oy0, np_, nr in zip(*_tiles(n * c, ho, plan)):
        plane0, oy0, np_, nr = (int(t) for t in (plane0, oy0, np_, nr))
        bands = -(-ho // plan.rows)
        iy0 = oy0 * stride - top
        rows_in = (nr - 1) * stride + k
        ylo, yhi = max(iy0, 0), min(iy0 + rows_in, h)
        ry0 = 0 if bands == 1 else ylo
        srows = h if bands == 1 else max(yhi - ylo, 0)
        count = np_ * srows * wd
        g0 = (plane0 * h + ry0) * wd
        xs = torch.full((plan.planes * g.plane_pitch,), float("nan"))
        # zeros: pad columns of rows inside the image, rows outside
        for pl in range(np_):
            for sr in range(rows_in):
                iy = iy0 + sr
                cols = (list(range(min(left, pw))) +
                        list(range(min(left + wd, pw), pw))
                        if 0 <= iy < h else list(range(pw)))
                base = pl * g.plane_pitch + sr * g.row_pitch
                for pc in cols:
                    xs[base + col(pc)] = 0.0
        # the span copied as the aligned vectors around it: every element
        # once; then laid out, rows and planes by multiply and shift
        lead = ((phase_bytes + g0 * es) % 16) // es
        nchunks = -(-(lead + count) // e16)
        e = torch.arange(nchunks * e16) - lead
        e = e[(e >= 0) & (e < count)]
        assert torch.equal(e, torch.arange(count))
        row = _divide(e, wd)
        pl, r = (_divide(row, h), row - _divide(row, h) * h) \
            if bands == 1 else (torch.zeros_like(row), row)
        assert torch.equal(row, e // wd)
        sr = r + ry0 - iy0
        pc = e - row * wd + left
        keep = (sr >= 0) & (sr < rows_in) & (pc < pw)
        idx = pl * g.plane_pitch + sr * g.row_pitch + col(pc)
        xs[idx[keep]] = flat[g0 + e[keep]].to(torch.float32)
        # strips
        strips = np_ * nr * g.spr
        i = torch.arange(strips)
        spl, srem = i // (nr * g.spr), i % (nr * g.spr)
        r, ox0 = srem // g.spr, (srem % g.spr) * v
        ch = (plane0 + spl) % c
        acc = torch.zeros(strips, v)
        for di in range(k):
            base = spl * g.plane_pitch + (r * stride + di) * g.row_pitch + ox0
            if stride == 1:
                vals = xs[base[:, None] + torch.arange(v + k - 1)]
                for dj in range(k):
                    acc = acc + vals[:, dj:dj + v] * wf[ch, di * k + dj, None]
            else:
                ne, no = v + (k - 1) // 2, v + (k - 3) // 2
                ev = xs[base[:, None] + torch.arange(ne)]
                od = xs[base[:, None] + g.half + torch.arange(no)]
                for dj in range(k):
                    src = od if dj % 2 else ev
                    acc = acc + (src[:, dj // 2:dj // 2 + v]
                                 * wf[ch, di * k + dj, None])
        y = acc * scale[ch, None] + shift[ch, None]
        ox = ox0[:, None] + torch.arange(v)
        pos = (spl[:, None] * nr + r[:, None]) * wo + ox
        keep = ox < wo
        # the tile's output span: the head, the 16-byte body, the tail
        total = np_ * nr * wo
        dst0 = (plane0 * ho + oy0) * wo
        phase = (phase_bytes + dst0 * es) % 16
        head = min(total, ((16 - phase) % 16) // es)
        body = (total - head) // e16
        span = torch.cat([torch.arange(head),
                          head + torch.arange(body * e16),
                          torch.arange(head + body * e16, total)])
        assert torch.equal(span, torch.arange(total))
        stage = torch.full((total,), float("nan"))
        stage[pos[keep]] = y[keep]
        out[dst0 + span] = stage[span]
        written[dst0 + span] += 1
    assert torch.all(written == 1)
    return k6.ACTIVATIONS[act](out.view(n, c, ho, wo)).to(x.dtype)


def _divide(v, d):
    """The kernel's v / d: (v * ceil(2^40 / d)) >> 40."""
    return (v * (((1 << 40) + d - 1) // d)) >> 40


def _dw_case(shape, k, dtype, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((c, 1, k, k)) * 0.3)
                         .astype(np.float32))
    return (x.to(dtype), w.to(dtype),
            torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            torch.from_numpy((rng.standard_normal(c) * 0.3)
                             .astype(np.float32)))


def _tf_pad(h, w, k, stride):
    from pytorchcv_tpu_torch.models.efficientnet import calc_tf_padding
    return calc_tf_padding(torch.empty(1, 1, h, w), k, stride)


_EMU_CASES = [
    # k, stride, pad, (n, c, h, w), act, forced plans
    # (v, planes, rows, threads)
    (3, 1, ((1, 1), (1, 1)), (2, 5, 13, 11), "swish",
     [(4, 3, 13, 64), (7, 1, 5, 32), (7, 2, 13, 32)]),
    (3, 2, "tf", (2, 3, 12, 10), "relu6",              # TF pad (0, 1)
     [(4, 1, 2, 32), (7, 2, 6, 32), (4, 4, 6, 64)]),
    (5, 1, ((2, 2), (2, 2)), (1, 4, 7, 9), "hswish",
     [(4, 3, 7, 32), (7, 1, 3, 32)]),
    (5, 2, "tf", (2, 3, 12, 14), "relu",               # TF pad (1, 2)
     [(7, 1, 2, 32), (4, 5, 6, 64)]),
    (5, 2, "tf", (1, 4, 11, 13), "sigmoid",            # odd: (2, 2)
     [(7, 3, 6, 64), (4, 1, 4, 32)]),
    (7, 1, ((3, 3), (3, 3)), (1, 3, 9, 8), "none",
     [(7, 2, 9, 32), (4, 1, 4, 32)]),
    (7, 2, "tf", (1, 3, 13, 15), "hsigmoid",
     [(4, 2, 7, 32), (7, 1, 3, 32)]),
    (3, 2, ((1, 1), (1, 1)), (1, 2, 9, 9), "none",
     [(7, 1, 1, 32), (4, 2, 5, 32)]),
    (3, 1, ((0, 0), (0, 0)), (1, 2, 5, 30), "relu",    # no pad, wide rows
     [(4, 1, 2, 32), (7, 2, 3, 32)]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", _EMU_CASES,
                         ids=[f"k{c[0]}s{c[1]}_{c[3][2]}x{c[3][3]}"
                              for c in _EMU_CASES])
def test_dwconv_tile_walk_is_bit_equal_to_the_plain_version(case, dtype):
    k, stride, pad, shape, act, plans = case
    if pad == "tf":
        pad = _tf_pad(shape[2], shape[3], k, stride)
    x, w, scale, shift = _dw_case(shape, k, dtype, k * 10 + shape[2])
    ref = k6.dwconv2d_bn_act_reference(x, w, scale, shift, stride, pad, act)
    plan = k6.dwconv_plan(*shape, k, stride, pad, dtype)
    es = x.element_size()
    for i, p in enumerate([plan] + [k6.DwPlan(*p) for p in plans]):
        phase = 6 * i % 16 // es * es      # x's address past 16 bytes
        got = _emulate(x, w, scale, shift, stride, pad, act, p, phase)
        assert torch.equal(got, ref), (p, phase)


# ------------------------------------------------------------- maxpool_i8

def _pool_walk(x, vb, run):
    """The kernel's walk: thread (b, run, pw, vector) takes output rows
    ph0 .. ph0 + run - 1 of column pw; row 2 ph + 1's max over the window's
    three columns is kept for the next output row. Returns the output and
    how often each output byte was written."""
    b, h, w, c = x.shape
    hp, wp = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    nv, runs = c // vb, -(-hp // run)
    t = np.arange(b * runs * wp * nv)
    cv, t = t % nv, t // nv
    pw, t = t % wp, t // wp
    rr, bb = t % runs, t // runs
    lanes = cv[:, None] * vb + np.arange(vb)[None, :]
    xi = x.astype(np.int16)

    def row_max(ih):
        m = np.full(lanes.shape, -128, np.int16)
        inside = (ih >= 0) & (ih < h)
        for dx in range(3):
            iw = 2 * pw - 1 + dx
            ok = inside & (iw >= 0) & (iw < w)
            v = xi[bb[ok, None], ih[ok, None], iw[ok, None], lanes[ok]]
            m[ok] = np.maximum(m[ok], v)
        return m
    out = np.zeros((b, hp, wp, c), np.int16)
    cover = np.zeros((b, hp, wp, c), np.int64)
    prev = row_max(2 * rr * run - 1)
    for j in range(run):
        ph = rr * run + j
        live = ph < hp
        m = np.maximum(row_max(2 * ph), prev)
        nxt = row_max(2 * ph + 1)
        m = np.maximum(m, nxt)
        idx = (bb[live, None], ph[live, None], pw[live, None], lanes[live])
        out[idx] = m[live]
        np.add.at(cover, idx, 1)
        prev = nxt
    return out.astype(np.int8), cover


@pytest.mark.parametrize("shape", [(2, 11, 13, 64), (1, 9, 7, 24),
                                   (1, 13, 11, 3), (1, 2, 1, 16),
                                   (3, 16, 16, 64)])
def test_maxpool_i8_walk_covers_every_output_once(shape):
    rng = np.random.default_rng(shape[1] * 7 + shape[3])
    x = rng.integers(-128, 128, shape, dtype=np.int8)
    x[0, 0, :, :] = -128                      # ties with the pad value
    ref = maxpool_i8_reference(torch.from_numpy(x)).numpy()
    vb_plan, run_plan = maxpool_plan(*shape, 16)
    assert shape[3] % vb_plan == 0
    for vb in (16, 8, 4, 1):
        if shape[3] % vb:
            continue
        for run in sorted({1, 2, 3, 8, run_plan}):
            got, cover = _pool_walk(x, vb, run)
            assert np.all(cover == 1), (vb, run)
            assert np.array_equal(got, ref), (vb, run)


@pytest.mark.parametrize("shape,align,expect", [
    ((128, 112, 112, 64), 16, 16), ((8, 240, 240, 128), 16, 16),
    ((1, 9, 7, 24), 16, 8), ((1, 13, 11, 3), 16, 1),
    ((2, 11, 10, 64), 4, 4), ((2, 11, 10, 64), 1, 1)])
def test_maxpool_plan_takes_the_widest_vector(shape, align, expect):
    vb, run = maxpool_plan(*shape, align)
    assert vb == expect and run == min(2, (shape[1] - 1) // 2 + 1)


# ------------------------------------------------------- K6 under autocast

def _bn_randomized(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def _cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))


@pytest.fixture
def k6_calls(monkeypatch):
    """The dtypes of the x and w that reach K6's wrapper."""
    seen = []
    orig = conv_mod.dwconv2d_bn_act

    def rec(x, w, *a):
        seen.append((x.dtype, w.dtype))
        return orig(x, w, *a)
    monkeypatch.setattr(conv_mod, "dwconv2d_bn_act", rec)
    return seen


def test_depthwise_block_under_bf16_autocast(k6_calls):
    """An f32 depthwise block fed by a 1x1 conv under bf16 autocast: K6
    on bf16 x and weight (it raised before), bf16 out, as the unfused
    route gives under the same autocast."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(8, 8, 1),
        ConvBlock(8, 8, 3, padding=1, groups=8, activation=Swish))
    _bn_randomized(net, 1).eval()
    x = torch.randn(2, 8, 9, 9)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        reset_launch_counts()
        y = net(x)
        assert k6_calls == [(torch.bfloat16, torch.bfloat16)]
        with unfused_depthwise(net):
            y_ref = net(x)
    assert y.dtype == torch.bfloat16 and LAUNCHES["dwconv"] == 0
    assert len(k6_calls) == 1 and _cosine(y, y_ref) >= 0.999


def test_efficientnet_under_autocast(k6_calls):
    """An f32 EfficientNet-B0 (64x64) eval forward: under bf16 autocast
    K6 runs in all 16 depthwise blocks at cosine >= 0.999 against the
    unfused route under the same autocast; under f16 autocast K6's wrapper
    is not called and the result is the unfused route's."""
    model = _bn_randomized(pt.get_model("efficientnet_b0", in_size=(64, 64),
                                        device="cpu"), 2).eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = model(x)
            assert len(k6_calls) == 16
            assert set(k6_calls) == {(torch.bfloat16, torch.bfloat16)}
            with unfused_depthwise(model):
                y_ref = model(x)
        assert len(k6_calls) == 16
        assert _cosine(y, y_ref) >= 0.999, _cosine(y, y_ref)
        with torch.autocast("cpu", dtype=torch.float16):
            y16 = model(x)
            with unfused_depthwise(model):
                y16_ref = model(x)
    assert len(k6_calls) == 16
    assert torch.equal(y16, y16_ref)
