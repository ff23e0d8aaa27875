"""K8 (the fused int8 bottleneck chain) through its plain PyTorch version
(CPU tensors), and the int8 ResNet plan's chain steps, against the JAX
package on the same numpy inputs.

``pack_units`` bit-equal to JAX's; the chain bit-exact against the Pallas
``fused_bottleneck_chain`` in interpret mode and against
``fused_chain_xla_ref``, at the JAX test's shape and at an odd one; the
chained plan of a small bottleneck ResNet bit-exact against JAX's
``prepare_int8_resnet`` infer fn. The plan comparison runs at a size where
the last feature map is 1x1 and the head is the identity, with an exact
stem (integer image, a kernel on a 2**-7 grid, no stem BN), so that every
int8 tensor of the two pipelines shows in the logits bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.kernels import fused_bottleneck as jfb
from pytorchcv_tpu.quant.resnet_int8 import \
    prepare_int8_resnet as jax_prepare
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels import fused_bottleneck as fb
from pytorchcv_tpu_torch.quant import prepare_int8_resnet

torch.set_num_threads(1)


def _mk_cell(rng, cin, cout, k, scale=0.05):
    kern = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * scale
    s_w = np.maximum(np.abs(kern).max(axis=(0, 1, 2)), 1e-12) / 127.0
    wq = np.clip(np.round(kern / s_w), -127, 127).astype(np.int8)
    return {"wq": wq,
            "gain": (s_w * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}


def _port_cell(c):
    return {"wq": torch.from_numpy(np.ascontiguousarray(
                c["wq"].transpose(3, 0, 1, 2))),
            "gain": torch.from_numpy(c["gain"]),
            "bias": torch.from_numpy(c["bias"]), "stride": 1, "dilation": 1}


def _chain_case(h, w, c, m, n_units, bsz, seed=0):
    rng = np.random.default_rng(seed)
    units = [{"conv1": _mk_cell(rng, c, m, 1), "conv2": _mk_cell(rng, m, m, 3),
              "conv3": _mk_cell(rng, m, c, 1)} for _ in range(n_units)]
    s_chain = [2.5] + [1.8, 2.1, 2.4] * n_units
    xq = rng.integers(-127, 128, (bsz, h, w, c), dtype=np.int8)
    return units, s_chain, xq


def _jax_units(units):
    return [{k: {f: jnp.asarray(a) for f, a in cell.items()}
             for k, cell in u.items()} for u in units]


def _port_pack(units, s_chain):
    return fb.pack_units([{k: _port_cell(cell) for k, cell in u.items()}
                          for u in units], s_chain)


def test_pack_units_bit_equal_to_jax():
    units, s_chain, _ = _chain_case(3, 5, 24, 12, 3, 1, seed=4)
    (w1, w2, w3, a1, b1, a2, b2, a3, b3, q, r) = (
        np.asarray(t) for t in jfb.pack_units(_jax_units(units), s_chain))
    got = _port_pack(units, s_chain)
    n, m, c = got["w1"].shape
    np.testing.assert_array_equal(got["w1"].numpy().transpose(0, 2, 1), w1)
    np.testing.assert_array_equal(
        got["w2"].numpy().transpose(0, 2, 3, 4, 1).reshape(n, 9, m, m), w2)
    np.testing.assert_array_equal(got["w3"].numpy().transpose(0, 2, 1), w3)
    for name, ref in (("a1", a1), ("b1", b1), ("a2", a2), ("b2", b2),
                      ("a3", a3), ("b3", b3)):
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), ref[:, 0], name)
    np.testing.assert_array_equal(np.asarray(got["q"], np.float32), q[:, 0])
    np.testing.assert_array_equal(np.asarray(got["r"], np.float32),
                                  r[:, 0, 0])


# (h, w, C, M, units, batch): the JAX test's shape and an odd one.
_SHAPES = [(4, 8, 128, 128, 2, 2), (7, 5, 64, 16, 3, 2)]


@pytest.mark.parametrize("shape", _SHAPES, ids=["jax_test", "odd"])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_ref"])
def test_chain_bit_exact_vs_jax(shape, ref):
    h, w, c, m, n_units, bsz = shape
    units, s_chain, xq = _chain_case(h, w, c, m, n_units, bsz)
    ju = _jax_units(units)
    if ref == "pallas_interpret":
        want = jfb.fused_bottleneck_chain(jnp.asarray(xq),
                                          jfb.pack_units(ju, s_chain), h, w,
                                          interpret=True)
    else:
        want = jfb.fused_chain_xla_ref(jnp.asarray(xq), ju, s_chain, h, w)
    got = fb.fused_bottleneck_chain(torch.from_numpy(xq),
                                    _port_pack(units, s_chain))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != 0).float().mean() > 0.3     # the chain is not saturated


def test_chain_refuses_what_k8_does_not_take():
    units, s_chain, xq = _chain_case(3, 4, 16, 8, 1, 1)
    packed = _port_pack(units, s_chain)
    with pytest.raises(ValueError, match="int8"):
        fb.fused_bottleneck_chain(torch.from_numpy(xq).float(), packed)
    with pytest.raises(ValueError, match="float32"):
        fb.fused_bottleneck_chain(torch.from_numpy(xq), dict(
            packed, a3=packed["a3"].double()))
    with pytest.raises(ValueError, match="no backward"):
        fb.fused_bottleneck_chain(torch.from_numpy(xq), dict(
            packed, a1=packed["a1"].clone().requires_grad_(True)))
    bad = [{k: _port_cell(cell) for k, cell in u.items()} for u in units]
    bad[0]["conv2"]["stride"] = 2
    with pytest.raises(ValueError, match="stride-1"):
        fb.pack_units(bad, s_chain)
    assert fb.fits(256, 64) and not fb.fits(256, 6) and \
        not fb.fits(2048, 2048)
    # one row of t1 and t2 must fit in 219 KB: W <= 53 at M 1024, 108 at 512
    assert fb.plan(128, 7, 7, 2048, 1024) == (7, 7)     # one block an SM
    assert fb._smem(*fb.plan(128, 56, 56, 256, 64), 64) <= \
        fb._SMEM_TWO                                     # two blocks an SM
    for w, m in ((60, 1024), (54, 1024), (109, 512)):
        with pytest.raises(ValueError, match="shared memory"):
            fb.plan(1, 4, w, 2048, m)


# The stride-1 chains of ResNet-50 and WRN-50-2 at 224x224: (H, W, C, M).
_CHAINS = {"resnet50": [(56, 56, 256, 64), (28, 28, 512, 128),
                        (14, 14, 1024, 256), (7, 7, 2048, 512)],
           "wrn50_2": [(56, 56, 256, 128), (28, 28, 512, 256),
                       (14, 14, 1024, 512), (7, 7, 2048, 1024)]}


def _blocks_cover_once(bsz, h, w, m, tile):
    """The kernel's grid under ``tile`` = (rows, columns): block (x, image)
    takes rows from (x // column tiles) * rows and columns from (x % column
    tiles) * columns. Each (image, row, column) is covered exactly once,
    within a block's shared memory."""
    th, tw = tile
    assert fb._smem(th, tw, m) <= fb._SMEM_ONE
    ncol = -(-w // tw)
    seen = np.zeros((bsz, h, w), np.int64)
    for bx in range(-(-h // th) * ncol):
        r0, c0 = bx // ncol * th, bx % ncol * tw
        seen[:, r0:r0 + th, c0:c0 + tw] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("name", sorted(_CHAINS))
@pytest.mark.parametrize("bsz", [128, 32, 3])
def test_plan_covers_every_row_once_within_shared_memory(name, bsz):
    """K8's plan (rows, columns a tile) on every chain shape and on the last
    stage at a 64x64 input (a 2x2 map): whole rows, each (image, row)
    covered exactly once, the shared bytes within a block's budget. A block
    takes one image: at ResNet-50's 7x7 stage 4 two images fit, but on the
    H100 two images a block took 0.942 ms a unit against 0.484 for one at
    batch 128 (64 blocks for 132 SMs)."""
    h4, w4, c4, m4 = _CHAINS[name][-1]
    for h, w, c, m in _CHAINS[name] + [(2, 2, c4, m4)]:
        tile = fb.plan(bsz, h, w, c, m)
        assert tile[1] == w and _blocks_cover_once(bsz, h, w, m, tile), \
            (h, w, c, m, tile)
    if name == "resnet50":
        assert fb.plan(bsz, 7, 7, 2048, 512) == (7, 7)


@pytest.mark.parametrize("h,w,c,m,whole_rows", [(4, 53, 2048, 1024, False),
                                                (3, 108, 2048, 512, False),
                                                (5, 46, 2048, 1024, True)])
def test_plan_takes_the_widest_rows_in_column_tiles(h, w, c, m, whole_rows):
    """Rows as wide as K8 takes (W 53 at M 1024, 108 at M 512) leave the
    weight ring no room beside one row's t1 and t2: the plan cuts one row
    into column tiles that cover each pixel once. At W 46 and M 1024 one
    row still fits."""
    th, tw = fb.plan(2, h, w, c, m)
    assert _blocks_cover_once(2, h, w, m, (th, tw))
    assert (tw == w) == whole_rows and (whole_rows or th == 1)


@pytest.mark.parametrize("name", sorted(_CHAINS))
@pytest.mark.parametrize("size", [224, 256, 320, 384, 448, 512, 640, 800,
                                  1024, 1280, 1472, 1696, 1728])
def test_plan_takes_every_chain_map_up_to_the_width_limit(name, size):
    """ResNet-50 and WRN-50-2 served at ``size`` x ``size``: their chain
    maps (``size`` / 4, 8, 16, 32) in tiles that cover each pixel once
    within shared memory, up to the widest row K8 takes. WRN-50-2's stage 4
    at 1728 px (W 54 at M 1024) is past it and raises; at 1696 px (W 53)
    and below every map is taken."""
    for (_, _, c, m), stride in zip(_CHAINS[name], (4, 8, 16, 32)):
        s = size // stride
        if (name, size, stride) == ("wrn50_2", 1728, 32):
            with pytest.raises(ValueError, match="shared memory"):
                fb.plan(2, s, s, c, m)
            continue
        assert _blocks_cover_once(2, s, s, m, fb.plan(2, s, s, c, m)), s


def test_fused_bottleneck_parts_match_the_kernel_source():
    """``kernels/fused_bottleneck_parts.py`` cuts K8's parts out of its
    source by pattern: every variant removes what it names."""
    from pytorchcv_tpu_torch.kernels._build import _CSRC
    from pytorchcv_tpu_torch.kernels.fused_bottleneck_parts import variants
    src = (_CSRC / "fused_bottleneck.cu").read_text()
    v = variants(src)
    count = {name: (t.count("mma_s8(acc"), t.count("cp_async16(dst"),
                    t.count("__ldg(e"), t.count("ldmatrix_x4(a, pa)"),
                    t.count("reinterpret_cast<const char2*>"))
             for name, t in v.items()}
    assert count["kernel"] == (1, 1, 4, 1, 1)
    assert count["no residual x loads"] == (1, 1, 4, 1, 0)
    assert count["no A, B loads"] == (1, 1, 0, 1, 1)
    assert count["no ring copies"] == (1, 0, 4, 1, 1)
    assert count["no products"] == (0, 1, 4, 1, 1)
    assert count["no products, no A ldmatrix"] == (0, 1, 4, 0, 1)
    assert count["no products, no ring copies"] == (0, 0, 4, 1, 1)
    assert "123456789" in v["no epilogues"] and "123456789" not in src


def _exact_stem_pair(name, size, classes, seed, **kw):
    """The JAX model and the port's on the same variables, with a BN-less
    biased stem whose kernel lies on a 2**-7 grid, BN elsewhere randomized,
    and an identity head of ``classes`` = the last width."""
    tm = pt.get_model(name, in_size=size, num_classes=classes, device="cpu",
                      **kw)
    jm = ptc.get_model(name, in_size=size, num_classes=classes, init=False,
                       **kw)
    rng = np.random.default_rng(seed)
    stem = tm.features.init_block.conv
    stem.bn = None
    stem.conv.bias = torch.nn.Parameter(torch.from_numpy(
        (rng.standard_normal(stem.conv.out_channels) * 0.1)
        .astype(np.float32)))
    with torch.no_grad():
        stem.conv.weight.copy_(torch.from_numpy(rng.integers(
            -127, 128, tuple(stem.conv.weight.shape)).astype(np.float32)
            / 128.0))
        tm.output.weight.copy_(torch.eye(classes))
        tm.output.bias.zero_()
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)
                                                .astype(np.float32)))
                m.bias.copy_(torch.from_numpy((rng.standard_normal(c) * 0.1)
                                              .astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(
                    (rng.standard_normal(c) * 0.5).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, c).astype(np.float32)))
    shapes = jm.shape_variables()
    ib_p = shapes["params"]["features"]["init_block"]["conv"]
    del ib_p["bn"]
    ib_p["conv"]["bias"] = jax.ShapeDtypeStruct(
        (stem.conv.out_channels,), jnp.float32)
    del shapes["batch_stats"]["features"]["init_block"]
    variables = convert_state_dict(tm.state_dict(), shapes)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    return jm, tm


def _scales(tm, seed):
    """Random per-layer amaxes, keyed as ``calibrate_int8``'s."""
    rng = np.random.default_rng(seed)
    return {name.replace(".", "/"): float(rng.uniform(1.0, 4.0))
            for name, m in tm.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}


def test_chained_plan_bit_exact_vs_jax_pipeline():
    """resnetbc38b (stride at conv2) at width 0.25 and 32x32: chains of 2, 2,
    2 and 1 units; the last map is 1x1."""
    jm, tm = _exact_stem_pair("resnetbc38b", (32, 32), 2048, 3,
                              width_scale=0.25)
    scales = _scales(tm, 5)
    x = np.random.default_rng(6).integers(-8, 9, (2, 3, 32, 32)
                                          ).astype(np.float32)
    fn, qtree = jax_prepare(jm, scales)
    want = np.asarray(jax.jit(fn)(qtree, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    infer, plan = prepare_int8_resnet(tm, scales)
    assert [len(u["chain"]["q"]) for u in plan["units"] if "chain" in u] \
        == [2, 2, 2, 1]
    got = infer(plan, torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    assert (want != 0).mean() > 0.2
    infer, k2_plan = prepare_int8_resnet(tm, scales, chains=False)
    assert not any("chain" in u for u in k2_plan["units"])
    assert torch.equal(infer(k2_plan, torch.from_numpy(x).to(torch.bfloat16)),
                       got)
