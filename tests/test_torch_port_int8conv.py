"""CPU checks of the tensor-core designs of K2 (the int8 conv,
``csrc/int8_conv.cu``) and K3 (the serving stem, ``csrc/stem.cu``), which
only run on the card:

* K2's plan covers every output tile once, within a block's shared memory,
  on every conv of ResNet-50, WRN-50-2 and DANet and at the card tests'
  shapes; the grouped K2's plan (``gconv_plan``) on every grouped conv of
  ResNeXt-50, SE-ResNeXt-50 and SENet-16 at batch 128, 32 and 3: two
  blocks an SM within shared memory, spatial tiles covering every output
  once, each n8 tile's groups inside its run's window;
* a torch emulation of K2's K walk (tap by tap, 64-byte chunks of Cin in
  two 32-byte mma steps, the image border and a tap's ragged end as zeros,
  int32 sums) and its epilogue is bit-equal to ``int8_conv_reference``;
* K3's K order (``stem_k_layout``: rows of 8 or 4 taps, one column shifted,
  zero padded) summed in f32 one 16-tap mma step at a time is within K3's
  gate of ``stem_conv_reference``; its plan fits shared memory.

No JAX: the plain versions are the references here (they are held against
the JAX package in ``tests/test_torch_port_kernels.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorchcv_tpu_torch.kernels import int8_conv as k2
from pytorchcv_tpu_torch.kernels import stem as k3
from pytorchcv_tpu_torch.kernels.int8_conv_plans import (conv_shapes,
                                                          gconv_shapes, out_hw)

_SMEM_MAX = 232_448

# The card tests' K2 shapes (tests/test_torch_port_cuda.py): batch, conv.
_CARD_CONVS = [(3, (3, 2, 1, 12, 24, 9, 9, True)),
               (3, (1, 1, 1, 36, 72, 5, 5, True)),
               (3, (3, 1, 1, 260, 20, 6, 6, True)),
               (3, (1, 2, 1, 4, 130, 11, 11, True))] + \
    [(2, (3, 1, d, 20, 70, hw, hw + 2, True)) for d, hw in
     ((2, 9), (4, 13), (2, 7))]


def _blocks_cover_once(m, cout, tile):
    """Every block's (first pixel, first channel) is a distinct tile origin
    inside the output, and the tiles cover [0, m) x [0, cout)."""
    bm, bn = tile
    nb = k2.blocks(m, cout, tile)
    origins = np.array([k2.block_tile(m, cout, tile, b) for b in range(nb)])
    assert len({tuple(o) for o in origins}) == nb
    assert (origins[:, 0] % bm == 0).all() and (origins[:, 1] % bn == 0).all()
    assert origins[:, 0].max() < m <= origins[:, 0].max() + bm
    assert origins[:, 1].max() < cout <= origins[:, 1].max() + bn
    assert nb == len(set(origins[:, 0])) * len(set(origins[:, 1]))


@pytest.mark.parametrize("name,bsz", [("resnet50", 3), ("resnet50", 32),
                                      ("resnet50", 128), ("wrn50_2", 3),
                                      ("wrn50_2", 32), ("wrn50_2", 128),
                                      ("danet", 2), ("danet", 8), ("card", 0)])
def test_plan_covers_every_output_tile_once_within_shared_memory(name, bsz):
    convs = _CARD_CONVS if name == "card" else \
        [(bsz, c) for c in conv_shapes(name)]
    for b, conv in convs:
        k, _, _, cin, cout = conv[:5]
        ho, wo = out_hw(conv)
        m = b * ho * wo
        tile = k2.plan(m, cout, cin, k)
        assert tile in k2.TILES
        assert k2.smem_bytes(*tile) <= _SMEM_MAX
        _blocks_cover_once(m, cout, tile)


def test_conv_shapes_are_the_paths_launch_counts():
    """19 K2 convs a ResNet forward and 54 a DANet forward, as the launch
    counts of ``chip_smoke.py`` say."""
    assert [len(conv_shapes(n)) for n in ("resnet50", "wrn50_2", "danet")] \
        == [19, 19, 54]


def _k_walk(x, w, stride, dilation):
    """K2's int32 sums as the kernel forms them: for each tap (r, s), for
    each 64-byte chunk of Cin, the chunk's activations of every output
    pixel (zeros outside the image and past Cin) against the chunk's
    weights (zeros past Cin), as two 32-byte mma steps, summed in int32."""
    b, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    pad = dilation * (k // 2)
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (wd + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    mm = torch.arange(b * ho * wo)
    ow, rest = mm % wo, mm // wo
    oh, img = rest % ho, rest // ho
    ih0, iw0 = oh * stride - pad, ow * stride - pad
    xf = x.reshape(-1).to(torch.int32)
    wf = w.reshape(cout, -1).to(torch.int32)
    acc = torch.zeros((b * ho * wo, cout), dtype=torch.int32)
    for r in range(k):
        for s in range(k):
            ih, iw = ih0 + r * dilation, iw0 + s * dilation
            inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd)
            pix = (img * h + ih.clamp(0, h - 1)) * wd + iw.clamp(0, wd - 1)
            for kc in range(-(-cin // 64)):
                kb = kc * 64 + torch.arange(64)
                valid = kb < cin
                kq = kb.clamp(max=cin - 1)
                a = torch.where(inside[:, None] & valid[None, :],
                                xf[pix[:, None] * cin + kq[None, :]], 0)
                wb = torch.where(valid[None, :],
                                 wf[:, (r * k + s) * cin + kq], 0)
                for half in (slice(0, 32), slice(32, 64)):
                    # one mma step: 32 products a sum, exact in int32
                    acc += (a[:, half].to(torch.float64)
                            @ wb[:, half].T.to(torch.float64)).to(torch.int32)
    return acc.reshape(b, ho, wo, cout)


@pytest.mark.parametrize("name", ["resnext50_32x4d", "seresnext50_32x4d",
                                  "senet16"])
@pytest.mark.parametrize("bsz", [128, 32, 3])
def test_gconv_plan_covers_every_output_within_shared_memory(name, bsz):
    """Every grouped conv of the path: the plan's tile is one of
    ``GCONV_TILES``, holds two blocks an SM, its spatial tiles cover the
    output map once (rows and columns of whole tiles, images in whole
    groups), every n8 tile's groups lie in its run's window of ``wb``
    bytes, and its copies fit the 256 threads."""
    convs = gconv_shapes(name)
    assert len(convs) == (4 if name == "senet16" else 16)
    for k, stride, cin, cout, groups, h, w in set(convs):
        plan = k2.gconv_plan(bsz, h, w, cin, cout, groups, k, stride, 1)
        assert (plan.bm, plan.bn) in k2.GCONV_TILES
        assert plan.per_sm == 2 and plan.smem <= _SMEM_MAX
        ho, wo = out_hw((k, stride, 1, cin, cout, h, w, False))
        it, rt, ct = k2.gconv_spatial_tiles(bsz, ho, wo, plan)
        assert plan.imgs * plan.th * plan.tw <= plan.bm
        assert (it - 1) * plan.imgs < bsz <= it * plan.imgs
        assert (rt - 1) * plan.th < ho <= rt * plan.th
        assert (ct - 1) * plan.tw < wo <= ct * plan.tw
        assert plan.imgs == 1 or (plan.th, plan.tw) == (ho, wo)
        for n0 in range(0, cout, plan.bn):
            for nj in range(n0, min(n0 + plan.bn, cout), 8):
                lo, hi = k2.gconv_window(n0, nj, cout, groups, cin, plan.u)
                assert lo <= nj // (cout // groups) * (cin // groups)
                assert hi <= lo + plan.wb and lo % plan.vec == 0
        assert 256 % (plan.bn // 8 // plan.u * plan.wb // plan.vec) == 0


def _k2_epilogue(acc, a, bias, act, q, residual, res_scale, round_res,
                 bend):
    """The kernel's epilogue per element: f32(acc) * A + B (two roundings),
    ReLU or the unit tail, the bend, then int8 or bf16."""
    y = acc.to(torch.float32) * a + bias
    if residual is None:
        if act == "relu":
            y = torch.clamp_min(y, 0.0)
    else:
        if residual.dtype == torch.int8:
            rv = residual.to(torch.float32) * res_scale
            if round_res:
                rv = rv.to(torch.bfloat16).to(torch.float32)
        else:
            rv = residual.to(torch.float32)
        y = torch.clamp_min(y.to(torch.bfloat16).to(torch.float32) + rv, 0.0)
    out = y.to(torch.bfloat16) if q is None else torch.clamp(
        torch.round(y * q), -127.0, 127.0).to(torch.int8)
    return (out, y.to(torch.bfloat16)) if bend else out


@pytest.mark.parametrize("k,stride,dilation,cin,cout,hw", [
    (3, 2, 1, 12, 24, 9), (3, 1, 2, 20, 16, 9), (3, 1, 4, 4, 8, 11),
    (1, 2, 1, 260, 24, 5), (3, 1, 1, 260, 8, 4)])
def test_k2_k_walk_emulation_bit_equal_to_plain(k, stride, dilation, cin,
                                                cout, hw):
    """Stride 2, dilation 2 and 4, Cin 4 / 12 / 20 / 260 (ragged chunks),
    every residual mode and the bend, with sums past 2**24."""
    rng = np.random.default_rng(k * 100 + cin)
    x = torch.from_numpy(rng.integers(-127, 128, (2, hw, hw + 1, cin),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin),
                                      dtype=np.int8))
    a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    acc = _k_walk(x, w, stride, dilation)
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   w.permute(0, 3, 1, 2).double(), stride=stride,
                   padding=dilation * (k // 2), dilation=dilation)
    assert torch.equal(acc, ref.permute(0, 2, 3, 1).to(torch.int32))
    shape = tuple(acc.shape)
    res_i8 = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    res_bf = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
    for kw in (dict(act="relu", q=0.7), dict(act=None),
               dict(act=None, q=0.7, residual=res_i8, res_scale=0.01,
                    round_res=True, bend=True),
               dict(act=None, q=0.7, residual=res_i8, res_scale=0.01),
               dict(act=None, residual=res_bf)):
        full = dict(act="relu", q=None, residual=None, res_scale=None,
                    round_res=False, bend=False)
        full.update(kw)
        got = _k2_epilogue(acc, a, b, **full)
        want = k2.int8_conv_reference(x, w, a, b, stride, dilation=dilation,
                                      **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), kw.keys()


def _k3_emulation(x, kf, bias, q):
    """K3 as the kernel sums: im2col in ``stem_k_layout``'s order (zero
    weights on the shifted and padding taps), then f32 sums of one
    16-tap step at a time added in turn, then bias, ReLU and quant."""
    k, cout = kf.shape[1], kf.shape[3]
    pad = k // 2
    bsz, _, h, w = x.shape
    ho, wo = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
    xp = F.pad(x.float(), (pad + 1, pad + 1, pad, pad))
    cols, wrows = [], []
    for tap in k3.stem_k_layout(k):
        c, r, s = tap if tap is not None else (0, 0, -1)
        cols.append(xp[:, c, r:r + 2 * ho - 1:2,
                       s + 1:s + 1 + 2 * wo - 1:2].reshape(bsz, -1))
        wrows.append(kf[c, r, s].float() if tap is not None
                     else torch.zeros(cout))
    a = torch.stack(cols, -1)                     # (B, pixels, K)
    wk = torch.stack(wrows, 0)                    # (K, Cout)
    acc = torch.zeros(a.shape[:2] + (cout,))
    for kc in range(0, a.shape[-1], 16):
        acc = acc + a[..., kc:kc + 16] @ wk[kc:kc + 16]
    y = torch.clamp_min(acc + bias, 0.0)
    yq = torch.clamp(torch.round(y * q), -127.0, 127.0).to(torch.int8)
    return yq.reshape(bsz, ho, wo, cout)


@pytest.mark.parametrize("k,cout", [(7, 64), (3, 64), (3, 32), (7, 16)])
def test_k3_k16_summation_order_within_gate(k, cout):
    """At most 1 off on at most 0.1 % of elements (the gate of
    ``chip_smoke.py`` and the card test)."""
    rng = np.random.default_rng(k + cout)
    x = torch.from_numpy(rng.standard_normal((2, 3, 38, 46)).astype(
        np.float32)).to(torch.bfloat16)
    kf = torch.from_numpy((rng.standard_normal((3, k, k, cout)) * 0.1)
                          .astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    got = _k3_emulation(x, kf, bias, 40.0)
    ref = k3.stem_conv_reference(x, kf, bias, 40.0)
    assert got.shape == ref.shape
    diff = (got.int() - ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3
    assert float((ref != 0).float().mean()) > 0.3


@pytest.mark.parametrize("b,h,w,k", [(128, 224, 224, 7), (3, 224, 224, 7),
                                     (8, 480, 480, 3), (2, 480, 480, 3),
                                     (2, 50, 46, 7), (1, 1728, 1728, 7)])
def test_k3_plan_fits_shared_memory(b, h, w, k):
    """The plan's rows fit a block (two an SM at the paths' shapes) and
    the K layout holds every tap once."""
    rows = k3.stem_plan(b, h, w, k)
    assert 1 <= rows <= 32
    assert k3.stem_smem(k, rows, w) <= _SMEM_MAX
    if w <= 480:
        assert k3.stem_smem(k, rows, w) <= 233_472 // 2 - 1_024
    taps = [t for t in k3.stem_k_layout(k) if t is not None]
    assert sorted(taps) == [(c, r, s) for c in range(3) for r in range(k)
                            for s in range(k)]
    assert len(k3.stem_k_layout(k)) % 16 == 0
