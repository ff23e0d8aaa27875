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
    # one row of t1 and t2 must fit in a block's shared memory
    assert fb.row_tile(7, 7, 2048, 1024) == 7       # one block an SM
    assert fb.row_tile(56, 56, 256, 64) == 8        # two blocks an SM
    with pytest.raises(ValueError, match="shared memory"):
        fb.row_tile(4, 60, 2048, 1024)


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
