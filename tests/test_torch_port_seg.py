"""The port's DANet segmentation slice against the JAX package, at 64x64 on
the same weights (carried by ``load_jax_variables``) and the same numpy
inputs: K2 dilated and its bend output, the deep stem (K3 3x3, K2,
``maxpool_i8``), the flash-attention plain version (K4), its tensor-core
design's split of p and the patterns of its parts script, the f32 model,
the int8 backbone, and the serving closure against its f32 oracle.

One JAX DANet is built per module; its BatchNorm tensors and every
``ScaleBlock.alpha`` are randomized (alpha's init is zero, which would make
both attention branches the identity).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from pytorchcv_tpu.quant import resnet_int8 as jq
from pytorchcv_tpu.quant.seg_backbone_int8 import \
    prepare_int8_seg_backbone as jax_prepare_seg
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels._build import _CSRC
from pytorchcv_tpu_torch.kernels.flash_attention import flash_attention
from pytorchcv_tpu_torch.kernels.flash_attention_parts import variants
from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv
from pytorchcv_tpu_torch.kernels.preprocess import (bf16_ulp_distance,
                                                    bf16_ulp_error)
from pytorchcv_tpu_torch.kernels.stem import maxpool_i8, stem_conv
from pytorchcv_tpu_torch.quant import (UnsupportedTreeError, calibrate_int8,
                                       is_seg_resnetd_backbone,
                                       prepare_int8_seg_backbone)
from pytorchcv_tpu_torch.quant.resnet_int8 import _cell, _f32
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_NAME = "danet_resnetd50b_cityscapes"
_SIZE = (64, 64)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _randomize(variables, seed):
    """BN scale/bias/mean/var and every alpha from a seeded generator.

    Two choices let the int8 pipelines be held bit for bit. ``var + eps``
    is 1/4, 1 or 4, whose rsqrt is exact (JAX's CPU rsqrt and torch's
    round other values differently, which would change the folded
    constants). The stem's conv1 kernel becomes multiples of 1/64: with
    inputs on a 1/4 grid its bf16 products then sum exactly in f32 in any
    order (a conv of arbitrary bf16 values rounds differently under
    another summation order)."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k, v in params.items():
            if k == "bn":
                c = v["scale"].shape[0]
                v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
                stats[k]["mean"] = (rng.standard_normal(c) * 0.5
                                    ).astype(np.float32)
                stats[k]["var"] = rng.choice(np.float32([0.25, 1.0, 4.0]),
                                             c) - np.float32(1e-5)
            elif k == "alpha":
                params[k] = rng.choice([-1.0, 1.0], 1).astype(np.float32) * \
                    rng.uniform(0.5, 1.5, 1).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))

    out = jax.tree_util.tree_map(np.array, variables)
    walk(out["params"], out["batch_stats"])
    kern = out["params"]["backbone"]["0"]["conv1"]["conv"]["kernel"]
    out["params"]["backbone"]["0"]["conv1"]["conv"]["kernel"] = (
        rng.integers(-16, 17, kern.shape) / 64.0).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def danet():
    """The JAX DANet and the port's on the same variables: the port's
    seeded init, converted by the JAX package's ``convert_state_dict``
    (the JAX model's own init is an XLA compile of the whole model),
    randomized, and carried back by ``load_jax_variables`` (its ``alpha``
    rule included)."""
    tm = pt.get_model(_NAME, in_size=_SIZE, device="cpu")
    jm = ptc.get_model(_NAME, in_size=_SIZE, init=False)
    variables = _randomize(convert_state_dict(
        tm.state_dict(), jm.shape_variables()), 0)
    load_jax_variables(tm, variables)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    return jm, tm


def _grid_image(seed, n=2):
    """NHWC f32 input on a 1/4 grid in [-2, 2] (exact in bf16)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (n, *_SIZE, 3)) / 4.0).astype(np.float32)


def _mk_cell(rng, cin, cout, k, scale=0.05):
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * scale
    s_w = np.maximum(np.abs(kern).max(axis=(0, 1, 2)), 1e-12) / 127.0
    wq = np.clip(np.round(kern / s_w), -127, 127).astype(np.int8)
    return {"wq": wq,
            "gain": (s_w * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}


def _jax_cell(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _port_cell(c, stride=1, dilation=1):
    return {"wq": torch.from_numpy(np.ascontiguousarray(
                c["wq"].transpose(3, 0, 1, 2))),
            "gain": torch.from_numpy(c["gain"]),
            "bias": torch.from_numpy(c["bias"]), "stride": stride,
            "dilation": dilation}


# ---------------------------------------------------------------- K2

@pytest.mark.parametrize("dilation,stride", [(1, 2), (2, 1), (4, 1)])
def test_int8_conv_dilated_bit_exact_vs_cell(dilation, stride):
    rng = np.random.default_rng(dilation * 10 + stride)
    cell = _mk_cell(rng, 16, 24, 3)
    xq = rng.integers(-127, 128, (2, 11, 10, 16), dtype=np.int8)
    for relu, s_out in ((True, 1.9), (False, None)):
        ref = jq._cell(jnp.asarray(xq), 2.7, _jax_cell(cell), stride, relu,
                       s_out, dilation=dilation)
        got = _cell(torch.from_numpy(xq), 2.7,
                    _port_cell(cell, dilation=dilation), stride, relu, s_out)
        assert tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), _np(ref))


def test_int8_conv_bend_output_bit_exact():
    """The last stage-3 unit's tail (seg_backbone_int8.py:148-162): int8 at
    the next scale, and the bf16 bend of the same ``y``, in one call."""
    rng = np.random.default_rng(8)
    last = _mk_cell(rng, 16, 32, 1)
    t_in = rng.integers(-127, 128, (2, 5, 6, 16), dtype=np.int8)
    xq = rng.integers(-127, 128, (2, 5, 6, 32), dtype=np.int8)
    s_last, s_in, s_next = 2.3, 1.7, 2.9
    t = jq._cell(jnp.asarray(t_in), s_last, _jax_cell(last), 1, False)
    idf = (jnp.asarray(xq).astype(jnp.float32) *
           (s_in / 127.0)).astype(jnp.bfloat16)
    y = jnp.maximum(t.astype(jnp.float32) + idf.astype(jnp.float32), 0.0)
    pc = _port_cell(last)
    out, bend = int8_conv(torch.from_numpy(t_in), pc["wq"],
                          pc["gain"] * _f32(s_last / 127.0), pc["bias"], 1,
                          act=None, q=_f32(127.0 / s_next),
                          residual=torch.from_numpy(xq),
                          res_scale=_f32(s_in / 127.0), round_res=True,
                          bend=True)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jq._quant(y, s_next)))
    np.testing.assert_array_equal(bend.to(torch.float32).numpy(),
                                  _np(y.astype(jnp.bfloat16)))


# ---------------------------------------------------------------- K3

def test_deep_stem_and_pool_bit_exact_vs_jax():
    """K3 3x3/s2 (no pool), the int8 conv2/conv3 cells and ``maxpool_i8``
    vs the JAX deep-stem ops (seg_backbone_int8.py:85-104), at the DANet
    stem's shapes, on grid inputs whose conv sums are exact."""
    rng = np.random.default_rng(5)
    x = _grid_image(6)
    kf = (rng.integers(-64, 65, (3, 3, 3, 64)) / 256.0).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    c2, c3 = _mk_cell(rng, 64, 64, 3), _mk_cell(rng, 64, 128, 3)
    s_c2, s_c3, s_u1 = 3.0, 2.5, 2.2
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(kf, jnp.bfloat16), (2, 2),
        [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    xq = jq._quant(jnp.maximum(y + bias, 0.0), s_c2)
    xq = jq._cell(xq, s_c2, _jax_cell(c2), 1, True, s_c3)
    xq = jq._cell(xq, s_c3, _jax_cell(c3), 1, True, s_u1)
    ref = np.asarray(jq._maxpool_i8(xq))
    got = stem_conv(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
        .contiguous(),
        torch.from_numpy(kf).permute(2, 0, 1, 3).to(torch.bfloat16)
        .contiguous(), torch.from_numpy(bias), _f32(127.0 / s_c2))
    assert tuple(got.shape) == (2, 32, 32, 64)
    got = _cell(got, s_c2, _port_cell(c2), 1, True, s_c3)
    got = maxpool_i8(_cell(got, s_c3, _port_cell(c3), 1, True, s_u1))
    assert tuple(got.shape) == ref.shape == (2, 16, 16, 128)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).mean() > 0.2          # the test exercises the range


# ---------------------------------------------------------------- K4

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(dtype):
    """The plain version vs the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((2, 72, 16)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 72, 24)).astype(np.float32)
    jd = getattr(jnp, dtype)
    ref = jax_flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), 0.7, False, True)
    td = getattr(torch, dtype)
    got = flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                          0.7)
    assert got.dtype == td and tuple(got.shape) == ref.shape == (2, 72, 24)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)
    else:
        ulp = bf16_ulp_distance(got, torch.from_numpy(_np(ref)))
        assert int(ulp.max()) <= 1, int(ulp.max())


def _split_attention(q, k, v, scale, tile=64):
    """K4's bf16 design in torch: f32 scores, the online softmax over
    64-key tiles (running max from -1e30, running sum), p split into two
    bf16 terms hi + lo, each multiplied by v in f32."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    s_all = q @ k.transpose(-1, -2) * scale
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    den = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, k.shape[-2], tile):
        s = s_all[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        hi = p.to(torch.bfloat16).to(torch.float32)
        lo = (p - hi).to(torch.bfloat16).to(torch.float32)
        vt = v[..., k0:k0 + tile, :]
        acc = acc * alpha + hi @ vt + lo @ vt
        den = den * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return acc / den


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_split_design_within_gates(dtype):
    """The p = hi + lo split of K4's tensor-core design against the plain
    version at L 67 (a ragged last tile): bf16 within 1 ulp
    (``bf16_ulp_error``), f32 within 1e-4 of max |plain|, the kernel's
    gates on the card."""
    rng = np.random.default_rng(11)
    td = getattr(torch, dtype)
    q, k = (torch.from_numpy(rng.standard_normal((2, 67, 64)).astype(
        np.float32) * 0.3).to(td) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 67, 96)).astype(
        np.float32)).to(td)
    ref = flash_attention(q, k, v, 0.9)
    got = _split_attention(q, k, v, 0.9)
    if dtype == "bfloat16":
        assert float(bf16_ulp_error(got.to(td), ref).max()) <= 1
    else:
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-4, err


def test_flash_attention_parts_match_the_kernel_source():
    """``kernels/flash_attention_parts.py`` cuts K4's parts out of its
    source by pattern: every variant removes what it names."""
    src = (_CSRC / "flash_attention.cu").read_text()
    v = variants(src)
    count = {name: (t.count("mma_bf16("), t.count("exp2f(sv"))
             for name, t in v.items()}
    assert count["kernel"] == (7, 1)   # the definition and 6 products
    assert count["no lo products"] == (5, 1)
    assert count["no p v products"] == (3, 1)
    assert count["no products"] == (1, 1)
    assert count["no exp2f"] == (7, 0)
    assert len(v["no p v products, no v loads"]) < len(v["no p v products"])


# ---------------------------------------------------------------- slice

def test_f32_danet_matches_jax(danet):
    """Max error relative to the largest output value, 5e-4: the measure
    and tolerance of this model in tests/test_torch_parity.py."""
    jm, tm = danet
    x = np.random.default_rng(4).standard_normal((2, *_SIZE, 3)).astype(
        np.float32)
    ref = jm(jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == r.shape == (2, 19, *_SIZE)
        err = float(np.abs(g.numpy() - r).max() / np.abs(r).max())
        assert err <= 5e-4, err


def test_int8_backbone_bit_exact_vs_jax(danet):
    jm, tm = danet
    x = _grid_image(7)
    scales = calibrate_int8(tm, [torch.from_numpy(_grid_image(8, n=4))
                                 .permute(0, 3, 1, 2)])
    fn, qtree = jax_prepare_seg(jm, scales)
    # XLA's fusion pass off, so that every op rounds as written (as eager
    # JAX and the K2 tests): fused, the bend rounds differently.
    ref4, ref3 = jax.jit(fn).lower(qtree, jnp.asarray(x)).compile(
        {"xla_disable_hlo_passes": "fusion"})(qtree, jnp.asarray(x))
    infer, plan = prepare_int8_seg_backbone(tm, scales, bend=True)
    got4, got3 = infer(plan, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got4.shape) == ref4.shape == (2, 8, 8, 2048)
    assert tuple(got3.shape) == ref3.shape == (2, 8, 8, 1024)
    np.testing.assert_array_equal(got4.to(torch.float32).numpy(), _np(ref4))
    np.testing.assert_array_equal(got3.to(torch.float32).numpy(), _np(ref3))
    assert float((got4 > 0).float().mean()) > 0.1
    # Without the bend (a head that reads stage 4 only) stage 4 is the same.
    infer, plan = prepare_int8_seg_backbone(tm, scales, bend=False)
    got4b, got3b = infer(plan, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got3b is None and torch.equal(got4b, got4)
    # Trees it does not walk: a classifier, and a 3x3 off the geometry.
    resnet = pt.get_model("resnet10", device="cpu")
    assert is_seg_resnetd_backbone(tm) and not is_seg_resnetd_backbone(resnet)
    with pytest.raises(UnsupportedTreeError, match="ResNet\\(D\\)"):
        prepare_int8_seg_backbone(resnet, scales)
    conv2 = tm.backbone[3].unit2.body.conv2.conv
    conv2.dilation = (4, 4)
    try:
        with pytest.raises(UnsupportedTreeError, match="3/unit2.*geometry"):
            prepare_int8_seg_backbone(tm, scales)
    finally:
        conv2.dilation = (2, 2)


def test_segmentation_serving_matches_reference_forward():
    """The int8 serving closure vs its f32 oracle: main-map cosine >= 0.99
    and per-pixel argmax agreement >= 0.97 (the gate tests/test_quant.py
    holds the JAX pipeline to), on a model built as that gate builds its
    own (default BatchNorm), at 96x96, with every alpha drawn as
    +-U(0.5, 1.5) from an explicit generator. The agreement counts the
    pixels whose f32 top-2 class margin is decisive (> 2 % of the largest
    logit, as ``_agreement`` in tests/test_quant.py and
    test_torch_port_model.py): random weights leave some pixels near a
    tie, whose argmax flips with the summation order alone (here: cosine
    0.9962; 97.5 % of the pixels decisive, agreeing at 0.981; plain
    agreement 0.969 on one thread, 0.974 on eight)."""
    model = pt.get_model(_NAME, in_size=(96, 96), rng=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "alpha"):
                mag = torch.empty(1).uniform_(0.5, 1.5, generator=g)
                m.alpha.copy_(mag if float(torch.rand(1, generator=g)) < 0.5
                              else -mag)
    serve = pt.make_serving_fn(_NAME, (104, 128), task="segmentation",
                               device="cpu", model=model)
    raw = np.random.default_rng(9).integers(0, 256, (2, 104, 128, 3),
                                            dtype=np.uint8)
    maps = serve(raw)
    ref = serve.make_reference_forward()(raw)
    assert serve.head.backbone is None and not type(model).reads_bend
    assert len(maps) == len(ref) == 3
    for m in maps:
        assert m.dtype == torch.bfloat16 and tuple(m.shape) == (2, 19, 96, 96)
        assert bool(torch.isfinite(m.float()).all())
    y, yf = maps[0].float(), ref[0]
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    top2 = yf.topk(2, dim=1).values
    decisive = (top2[:, 0] - top2[:, 1]) / yf.abs().amax(dim=1) > 0.02
    same = y.argmax(1) == yf.argmax(1)
    agree = float(same[decisive].float().mean())
    assert float(decisive.float().mean()) > 0.9
    assert cos >= 0.99 and agree >= 0.97, (cos, agree)
