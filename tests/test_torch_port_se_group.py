"""SE-ResNet, ResNeXt, SE-ResNeXt and SENet in the port against the JAX
package, on the same weights (the port's, converted by the JAX package's
``convert_state_dict``, BN and SE biases randomized from a seed) and the
same numpy inputs.

f32 forwards of each new model file at narrow widths and 64x64; the JAX
tree loaded back through ``load_jax_variables`` (strict); ``calibrate_int8``'s
key set against the JAX package's; the grouped K2 through its plain
version bit-exact against JAX ``_cell`` with the grouped kernel as it is
and merged block-diagonal (``_merge_grouped_weights``); the grouped
kernel's block-diagonal walk (window-major halo, tables, k32 chunks),
emulated in torch under every grouped tile, bit-equal to JAX ``_conv_i8``
and the plain version; K11's plain version against JAX's SE tail
handed JAX's gate; the int8 route end to end at 64x64 against JAX's
``prepare_int8_resnet`` (resnext14_32x4d bit-exact with an exact stem;
seresnet18 and senet16 at cosine >= 0.999: the squeeze's f32 mean sums in
another order than XLA's); ``make_serving_fn`` on the CPU for one name of
each family; and K10's table and gather, emulated in torch, bit-equal to
the fixed-order sum.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu.model import Model
from pytorchcv_tpu.models.resnext import ResNeXt as JaxResNeXt
from pytorchcv_tpu.models.senet import SENet as JaxSENet
from pytorchcv_tpu.models.seresnet import SEResNet as JaxSEResNet
from pytorchcv_tpu.models.seresnext import SEResNeXt as JaxSEResNeXt
from pytorchcv_tpu.quant import resnet_int8 as jq
from pytorchcv_tpu.quant.ptq import calibrate_int8 as jax_calibrate
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels import int8_conv as k2
from pytorchcv_tpu_torch.kernels.patch_probe import (
    PATCH_COLS, PATCH_ROWS, clamped_starts, distinct_windows,
    patch_window_sum_reference, window_index)
from pytorchcv_tpu_torch.kernels.se_tail import se_gate, se_tail
from pytorchcv_tpu_torch.model_provider import _init_weights
from pytorchcv_tpu_torch.models import get_constructor
from pytorchcv_tpu_torch.models.resnext import ResNeXt
from pytorchcv_tpu_torch.models.senet import SENet
from pytorchcv_tpu_torch.models.seresnet import SEResNet
from pytorchcv_tpu_torch.models.seresnext import SEResNeXt
from pytorchcv_tpu_torch.quant import calibrate_int8, prepare_int8_resnet
from pytorchcv_tpu_torch.quant.resnet_int8 import _conv_step, _f32, _run_step
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)


def _randomize(tm, rng):
    """BN statistics and affine, and every conv and linear bias (the SE
    gates' among them), from ``rng``."""
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    (rng.standard_normal(c) * 0.1).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(
                    (rng.standard_normal(c) * 0.5).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, c).astype(np.float32)))
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and \
                    m.bias is not None:
                m.bias.copy_(torch.from_numpy(
                    (rng.standard_normal(m.bias.shape) * 0.1)
                    .astype(np.float32)))


def _jax_twin(jm, tm):
    """``jm`` carrying ``tm``'s weights."""
    variables = convert_state_dict(tm.state_dict(), jm.shape_variables())
    return dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))


_NARROW = {
    # name: (port constructor, JAX constructor, arguments); group widths
    # cg 4 and 8 (ResNeXt, SE-ResNeXt), cg 2 -> og 4 (SENet)
    "resnext": (ResNeXt, JaxResNeXt, ([[64, 64], [128]], 32, 8, 16)),
    "seresnet": (SEResNet, JaxSEResNet, ([[32, 32], [64]], 16, False,
                                         True)),
    "seresnetbc_b": (SEResNet, JaxSEResNet, ([[64], [128, 128]], 16, True,
                                             False)),
    "seresnext": (SEResNeXt, JaxSEResNeXt, ([[64], [128]], 32, 8, 16)),
    "senet": (SENet, JaxSENet, ([[64], [128]], 32, 8, 16)),
}


@pytest.mark.parametrize("family", sorted(_NARROW))
def test_f32_narrow_model_matches_jax(family):
    """Narrow widths at 64x64; the JAX tree loads back into a fresh port
    model through ``load_jax_variables``, leaf for leaf."""
    ctor, jctor, args = _NARROW[family]
    tm = ctor(*args, in_size=(64, 64), num_classes=10)
    _init_weights(tm, 0)
    _randomize(tm, np.random.default_rng(1))
    tm.eval()
    jm = _jax_twin(Model(name=family, module=jctor(
        *args, in_size=(64, 64), num_classes=10)), tm)
    fresh = ctor(*args, in_size=(64, 64), num_classes=10)
    load_jax_variables(fresh, jax.tree_util.tree_map(np.asarray,
                                                     jm.variables))
    for key, value in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)
                                                 ).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 10)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= 2e-4, rel


def test_load_jax_variables_is_strict_on_the_new_trees():
    """A leaf with no port tensor (an SE gate's dense kernel where the port
    has 1x1 convs) and a missing leaf (SENet's ``output/fc``) raise."""
    from pytorchcv_tpu_torch.zoo.convert import ConversionError
    tm = SENet([[64], [128]], 32, 8, 16, in_size=(64, 64), num_classes=10)
    jm = _jax_twin(Model(name="senet", module=JaxSENet(
        [[64], [128]], 32, 8, 16, in_size=(64, 64), num_classes=10)), tm)
    variables = jax.tree_util.tree_map(np.asarray, jm.variables)
    se = variables["params"]["features"]["stage1"]["unit1"]["se"]
    se["fc1"] = {"kernel": se["conv1"]["kernel"][0, 0]}
    with pytest.raises(ConversionError, match="fc1"):
        load_jax_variables(tm, variables)
    del se["fc1"]
    del variables["params"]["output"]["fc"]
    with pytest.raises(ConversionError, match="output.fc"):
        load_jax_variables(tm, variables)


# ---------------------------------------------------------------- K2 grouped

def _grouped_case(rng, cg, og, groups, k=3, hw=(7, 9), bsz=2):
    cin, cout = cg * groups, og * groups
    x = rng.integers(-127, 128, (bsz, *hw, cin), dtype=np.int8)
    kern = rng.standard_normal((k, k, cg, cout)).astype(np.float32)
    s_w = np.abs(kern).max(axis=(0, 1, 2)) / 127.0
    cell = {"wq": np.clip(np.round(kern / s_w), -127, 127).astype(np.int8),
            "gain": (s_w * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}
    return x, cell


def _port_cell(cell, stride, groups):
    return {"wq": torch.from_numpy(np.ascontiguousarray(
                cell["wq"].transpose(3, 0, 1, 2))),
            "gain": torch.from_numpy(cell["gain"]),
            "bias": torch.from_numpy(cell["bias"]), "stride": stride,
            "dilation": 1, "groups": groups}


@pytest.mark.parametrize("cg,og,groups,stride", [
    (2, 2, 32, 1), (2, 4, 16, 2), (4, 4, 32, 2), (32, 32, 4, 1)])
def test_grouped_int8_conv_bit_exact_vs_jax_cell(cg, og, groups, stride):
    """The plain grouped K2 against JAX ``_cell`` on the grouped kernel as
    it is and merged block-diagonal (``_merge_grouped_weights`` at
    group_block 32), int8 and bf16 outputs."""
    rng = np.random.default_rng(cg * 100 + og)
    x, cell = _grouped_case(rng, cg, og, groups)
    s_in, s_out = 2.5, 1.7
    jcell = {f: jnp.asarray(a) for f, a in cell.items()}
    tree = {"stage1": {"unit1": {"body": {
        "conv1": {"wq": jnp.zeros((1, 1, 8, cg * groups), jnp.int8)},
        "conv2": jcell}}}}
    merged = jq._merge_grouped_weights(tree, 32)["stage1"]["unit1"][
        "body"]["conv2"]
    assert merged["wq"].shape[2] == (cg * groups if cg < 32 else cg)
    pcell = _port_cell(cell, stride, groups)
    for s_o in (s_out, None):
        got = _run_step(_conv_step(pcell, s_in, True, s_o),
                        torch.from_numpy(x))
        got = got.to(torch.float32).numpy()
        for jc in (jcell, merged):
            want = jq._cell(jnp.asarray(x), s_in, jc, stride, True, s_o)
            np.testing.assert_array_equal(
                got, np.asarray(want.astype(jnp.float32)))


def _emulated_grouped_acc(x, w, groups, stride, dilation, plan, rng):
    """The grouped kernel's int32 sums under ``plan``, walked as it walks
    them: per (channel tile, spatial tile) the halo window-major (one slab
    per run of u n8 tiles: each halo pixel's wb bytes from the run's window
    start, zeros outside the images and past Cin, random bytes where the
    kernel leaves shared memory stale), the block's tables from
    ``gconv_tables`` (B fragments zero off the diagonal, each piece's halo
    offset), and for each row of the tile, n8 tile and k32 chunk lane t's
    8 bytes of A at the row's halo pixel + piece t's offset against the 8 B
    columns; each valid output written once."""
    bsz, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    pad = dilation * (k // 2)
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (wd + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    it, rt, ct = k2.gconv_spatial_tiles(bsz, ho, wo, plan)
    per_tile = plan.imgs * plan.th * plan.tw
    r = torch.arange(plan.bm)
    im, ohl, owl = (r // (plan.th * plan.tw), r % (plan.th * plan.tw)
                    // plan.tw, r % plan.tw)
    rb = torch.where(r < per_tile, ((im * plan.hr + ohl * stride) * plan.hc
                                    + owl * stride) * plan.wb, 0)
    him, hr, hc = torch.meshgrid(torch.arange(plan.imgs),
                                 torch.arange(plan.hr),
                                 torch.arange(plan.hc), indexing="ij")
    xl = x.to(torch.int64)
    out = torch.zeros((bsz, ho, wo, cout), dtype=torch.int64)
    seen = torch.zeros((bsz, ho, wo, cout), dtype=torch.int64)
    nw, pixels = plan.bn // 8 // plan.u, plan.imgs * plan.hr * plan.hc
    for n0 in range(0, cout, plan.bn):
        off, bt = k2.gconv_tables(w, groups, cin, n0, plan, k, dilation)
        runs = [n0 + 8 * plan.u * jw for jw in range(nw)]
        los = [k2.gconv_window(n0, nj, cout, groups, cin, plan.u)[0]
               if nj < cout else 0 for nj in runs]
        chan = torch.tensor(los)[:, None] + torch.arange(plan.wb)
        for sp in range(it * rt * ct):
            img0 = sp // (rt * ct) * plan.imgs
            oh0, ow0 = sp // ct % rt * plan.th, sp % ct * plan.tw
            img = (img0 + him).reshape(1, -1, 1)
            ih = (oh0 * stride - pad + hr).reshape(1, -1, 1)
            iw = (ow0 * stride - pad + hc).reshape(1, -1, 1)
            ch3 = chan[:, None, :]
            inside = ((img < bsz) & (ih >= 0) & (ih < h) & (iw >= 0) &
                      (iw < wd) & (ch3 < cin))
            halo = torch.where(inside, xl[img.clamp(max=bsz - 1),
                                          ih.clamp(0, h - 1),
                                          iw.clamp(0, wd - 1),
                                          ch3.clamp(max=cin - 1)], 0)
            region = torch.from_numpy(rng.integers(-128, 128,
                                                   (nw, plan.slab)))
            region[:, :pixels * plan.wb] = halo.reshape(nw, -1)
            region = region.reshape(-1)
            a = region[rb[:, None, None, None, None, None]
                       + off[None, ..., None, None]
                       + 4 * torch.arange(2)[:, None] + torch.arange(4)]
            acc = torch.einsum("pjcthb,jcthbg->pjg", a, bt).reshape(
                plan.bm, -1)                       # a: (bm, nb, ch, 4, 2, 4)
            oimg, oh, ow = img0 + im, oh0 + ohl, ow0 + owl
            n = n0 + torch.arange(plan.bn)
            keep = ((r < per_tile) & (oimg < bsz) & (oh < ho) &
                    (ow < wo))[:, None] & (n < cout)
            rows, cols = keep.nonzero(as_tuple=True)
            idx = (oimg[rows], oh[rows], ow[rows], n[cols])
            out[idx] = acc[rows, cols]
            seen[idx] += 1
    assert torch.equal(seen, torch.ones_like(seen)), "not every output once"
    return out


@pytest.mark.parametrize("cg,og,groups,stride,hw,dilation", [
    (2, 2, 32, 1, (5, 7), 1), (2, 4, 16, 2, (9, 6), 1),
    (4, 4, 8, 1, (6, 6), 1), (4, 8, 8, 2, (7, 7), 1),
    (8, 8, 8, 1, (5, 6), 1), (8, 16, 4, 2, (7, 5), 1),
    (16, 16, 4, 1, (6, 5), 1), (16, 32, 2, 2, (5, 9), 1),
    (32, 32, 3, 1, (4, 5), 1), (2, 6, 5, 1, (9, 13), 1),
    (4, 2, 7, 1, (5, 6), 1), (8, 8, 16, 1, (6, 7), 2)])
def test_grouped_tile_walk_bit_equal_to_plain(cg, og, groups, stride, hw,
                                              dilation):
    """Under every tile of ``GCONV_TILES`` (the plan's among them): the
    block-diagonal walk covers every output once (channel tiles ragged past
    Cout, spatial tiles past the map, rows past the tile), its sums equal
    JAX ``_conv_i8``'s and, through the epilogue, give the plain version's
    int8 bit for bit."""
    rng = np.random.default_rng(cg + og + groups)
    x, cell = _grouped_case(rng, cg, og, groups, hw=hw, bsz=3)
    xt = torch.from_numpy(x)
    pcell = _port_cell(cell, stride, groups)
    pcell["dilation"] = dilation
    want = np.asarray(jq._conv_i8(jnp.asarray(x), jnp.asarray(cell["wq"]),
                                  stride, dilation=dilation))
    step = _conv_step(pcell, 2.5, True, 1.7)
    ref = _run_step(step, xt)
    args = (3, *hw, cg * groups, og * groups, groups, 3, stride, dilation)
    plans = [k2.gconv_tile(*args, *t) for t in k2.GCONV_TILES]
    assert k2.gconv_plan(*args) in plans
    for plan in plans:
        acc = _emulated_grouped_acc(xt, pcell["wq"], groups, stride,
                                    dilation, plan, rng)
        np.testing.assert_array_equal(acc.numpy(), want)
        y = torch.clamp_min(acc.to(torch.float32) * step["a"] + step["b"],
                            0.0)
        emulated = torch.clamp(torch.round(y * step["q"]), -127, 127).to(
            torch.int8)
        assert torch.equal(emulated, ref), plan


def test_grouped_int8_conv_rejects_what_the_kernel_does_not_take():
    ab = torch.zeros(24)
    x = torch.zeros((1, 4, 4, 24), dtype=torch.int8)
    with pytest.raises(ValueError, match="input widths"):
        k2.int8_conv(x, torch.zeros((24, 3, 3, 3), dtype=torch.int8), ab,
                     ab, groups=8)                  # cg 3
    with pytest.raises(ValueError, match="even output widths"):
        k2.int8_conv(x[..., :12], torch.zeros((21, 3, 3, 4),
                                              dtype=torch.int8), ab, ab,
                     groups=3)                      # og 7
    with pytest.raises(ValueError, match="grouped"):
        k2.int8_conv(x, torch.zeros((24, 3, 3, 4), dtype=torch.int8), ab,
                     ab, groups=5)


# ---------------------------------------------------------------- K11

def _jax_gate(t, se):
    """The gate inside JAX ``_se_gate``, written out with its ops."""
    p = jnp.mean(t.astype(jnp.float32), axis=(1, 2), keepdims=True)
    h = jnp.maximum(jnp.einsum("bijc,cm->bijm", p, se["conv1"]["kernel"][
        0, 0]) + se["conv1"]["bias"], 0.0)
    return jax.nn.sigmoid(jnp.einsum("bijm,mc->bijc", h, se["conv2"][
        "kernel"][0, 0]) + se["conv2"]["bias"])[:, 0, 0]


@pytest.mark.parametrize("residual", ["int8_identity", "int8_own",
                                      "bf16_identity"])
@pytest.mark.parametrize("out", ["int8", "bf16"])
def test_se_tail_plain_bit_exact_vs_jax(residual, out):
    """K11's plain version handed JAX's gate against the tail of JAX
    ``_forward`` (:331-361): ``_se_gate``'s product, the identity term
    (int8 at s_next, the unit's own int8 input rounded to bf16, or a bf16
    identity conv), add, ReLU, int8 at s_next or bf16; ``se_gate`` within
    1e-6 of JAX's gate."""
    rng = np.random.default_rng(len(residual) + len(out))
    b, h, w, c, m = 2, 5, 6, 48, 3
    t = jnp.asarray(rng.standard_normal((b, h, w, c)) * 2, jnp.bfloat16)
    se = {"conv1": {"kernel": jnp.asarray(
              rng.standard_normal((1, 1, c, m)) * 0.3, jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(m) * 0.1,
                                  jnp.float32)},
          "conv2": {"kernel": jnp.asarray(
              rng.standard_normal((1, 1, m, c)) * 0.3, jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(c) * 0.1,
                                  jnp.float32)}}
    g = _jax_gate(t, se)
    ts = jq._se_gate(t, se)
    np.testing.assert_array_equal(       # it is _se_gate's own gate
        np.asarray(ts.astype(jnp.float32)),
        np.asarray((t.astype(jnp.float32) * g[:, None, None, :])
                   .astype(jnp.bfloat16).astype(jnp.float32)))
    s_in, s_next = 2.3, 1.9
    q8 = rng.integers(-127, 128, (b, h, w, c), dtype=np.int8)
    if residual == "int8_identity":
        idf = jnp.asarray(q8).astype(jnp.float32) * (s_next / 127.0)
        port_res = dict(residual=torch.from_numpy(q8),
                        res_scale=_f32(s_next / 127.0))
    elif residual == "int8_own":
        idf = (jnp.asarray(q8).astype(jnp.float32) * (s_in / 127.0)
               ).astype(jnp.bfloat16)
        port_res = dict(residual=torch.from_numpy(q8),
                        res_scale=_f32(s_in / 127.0), round_res=True)
    else:
        idf = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.bfloat16)
        port_res = dict(residual=torch.from_numpy(np.array(
            idf.astype(jnp.float32))).to(torch.bfloat16))
    y = jnp.maximum(ts.astype(jnp.float32) + idf.astype(jnp.float32), 0.0)
    want = y.astype(jnp.bfloat16) if out == "bf16" else jq._quant(y, s_next)
    tt = torch.from_numpy(np.array(t.astype(jnp.float32))).to(
        torch.bfloat16)
    got = se_tail(tt, torch.from_numpy(np.array(g)),
                  q=_f32(127.0 / s_next) if out == "int8" else None,
                  **port_res)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    k = {n: torch.from_numpy(np.array(se[f"conv{i}"][f]))
         for i in (1, 2) for n, f in ((f"k{i}", "kernel"), (f"b{i}", "bias"))}
    gp = se_gate(tt, k["k1"][0, 0], k["b1"], k["k2"][0, 0], k["b2"])
    np.testing.assert_allclose(gp.numpy(), np.asarray(g), rtol=0, atol=1e-6)


def test_se_consts_take_both_parameterizations():
    """An SE gate as 1x1 convs (the port's ``SEBlock``) and as dense layers
    (``fc1``/``fc2``, JAX ``SEBlock(use_conv=False)``) on the same weights
    give the same products, and ``se_gate`` the block's own gate within
    1e-6; other activations raise."""
    from pytorchcv_tpu_torch.nn.activ import lambda_swish
    from pytorchcv_tpu_torch.nn.att import SEBlock
    from pytorchcv_tpu_torch.quant.resnet_int8 import (UnsupportedTreeError,
                                                       _se_consts)
    se = SEBlock(64)
    _randomize(se, np.random.default_rng(7))
    dense = torch.nn.Module()
    dense.fc1, dense.activ = torch.nn.Linear(64, 4), torch.nn.ReLU()
    dense.fc2, dense.sigmoid = torch.nn.Linear(4, 64), torch.nn.Sigmoid()
    with torch.no_grad():
        for fc, conv in ((dense.fc1, se.conv1), (dense.fc2, se.conv2)):
            fc.weight.copy_(conv.weight[:, :, 0, 0])
            fc.bias.copy_(conv.bias)
    a, b = _se_consts(se, "se"), _se_consts(dense, "se")
    assert all(torch.equal(a[k], b[k]) for k in a)
    t = torch.randn((2, 5, 6, 64), generator=torch.Generator().manual_seed(8)
                    ).to(torch.bfloat16)
    with torch.no_grad():
        p = t.float().mean(dim=(1, 2))[:, :, None, None]
        want = se.sigmoid(se.conv2(se.activ(se.conv1(p))))[:, :, 0, 0]
    np.testing.assert_allclose(se_gate(t, **a).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)
    with pytest.raises(UnsupportedTreeError, match="activations"):
        _se_consts(SEBlock(64, mid_activation=lambda_swish()), "se")


# ------------------------------------------------- the int8 route, end to end

@functools.lru_cache(maxsize=None)
def _int8_pair(name, exact_stem):
    """The port model and its JAX twin at 64x64 on one set of variables,
    with their calibrated scales on one batch. With ``exact_stem`` the stem
    is BN-less and biased with a kernel on a 2**-7 grid, the head the
    identity (classes = the last width) and the image integer, so the bf16
    stem is exact and every int8 tensor shows in the logits."""
    classes = 2048 if exact_stem else 1000
    tm = pt.get_model(name, in_size=(64, 64), num_classes=classes,
                      device="cpu")
    rng = np.random.default_rng(3)
    _randomize(tm, rng)
    jm = ptc.get_model(name, in_size=(64, 64), num_classes=classes,
                       init=False)
    shapes = jm.shape_variables()
    if exact_stem:
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
        ib_p = shapes["params"]["features"]["init_block"]["conv"]
        del ib_p["bn"]
        ib_p["conv"]["bias"] = jax.ShapeDtypeStruct(
            (stem.conv.out_channels,), jnp.float32)
        del shapes["batch_stats"]["features"]["init_block"]
        x = rng.integers(-8, 9, (2, 3, 64, 64)).astype(np.float32)
    else:
        x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    variables = convert_state_dict(tm.state_dict(), shapes)
    jm = dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))
    scales = calibrate_int8(tm, [torch.from_numpy(x)])
    return tm, jm, x, scales


@pytest.mark.parametrize("name", ["resnext14_32x4d", "seresnet18",
                                  "senet16"])
def test_calibrate_int8_key_set_matches_jax(name):
    """Every conv and linear input of the model, the SE gates' 1x1 convs
    and SENet's ``output/fc`` included, as the JAX package records them;
    the amaxes agree within 1e-4 (the f32 forwards sum apart)."""
    tm, jm, x, scales = _int8_pair(name, False)
    want = jax_calibrate(jm, [jnp.asarray(x.transpose(0, 2, 3, 1))])
    assert sorted(scales) == sorted(want)
    assert any("/se/conv1" in k for k in scales) == (name != "resnext14_32x4d")
    for key, v in want.items():
        assert abs(scales[key] - v) <= 1e-4 * v, key


@pytest.mark.parametrize("group_block", [32, None])
def test_int8_resnext14_bit_exact_vs_jax(group_block):
    """resnext14_32x4d (cg 4, 8, 16, 32, stride at the grouped 3x3) on the
    port's route against JAX's ``prepare_int8_resnet`` with its grouped
    kernels merged (group_block 32) and native (None): bit for bit."""
    tm, jm, x, scales = _int8_pair("resnext14_32x4d", True)
    fn, qtree = jq.prepare_int8_resnet(jm, scales, group_block=group_block)
    want = np.asarray(jax.jit(fn)(qtree, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    infer, plan = prepare_int8_resnet(tm, scales)
    assert not any("chain" in u for u in plan["units"])
    assert [u["body"][1]["groups"] for u in plan["units"]] == [32] * 4
    got = infer(plan, torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    assert (want != 0).mean() > 0.2


@pytest.mark.parametrize("name", ["seresnet18", "senet16"])
def test_int8_se_route_vs_jax(name):
    """SE units (K2 to bf16, the gate, K11), SENet's deep stem (K3 3x3 then
    K2 twice) and 3x3 identity convs: cosine >= 0.999 against JAX's
    ``prepare_int8_resnet``. Not bit-exact: the squeeze's f32 mean sums in
    another order than XLA's, and a gate one ulp apart moves a requantized
    value by one step."""
    tm, jm, x, scales = _int8_pair(name, False)
    fn, qtree = jq.prepare_int8_resnet(jm, scales)
    want = np.asarray(jax.jit(fn)(qtree, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    infer, plan = prepare_int8_resnet(tm, scales)
    assert all("se" in u for u in plan["units"])
    assert len(plan["stem_convs"]) == (2 if name == "senet16" else 0)
    got = infer(plan, torch.from_numpy(x).to(torch.bfloat16)).to(
        torch.float32).numpy()
    cos = float((got * want).sum() / (np.linalg.norm(got) *
                                      np.linalg.norm(want)))
    assert cos >= 0.999, cos


_NEW_NAMES = sorted(n for n in pt.registered_models()
                    if get_constructor(n).__module__.rsplit(".", 1)[-1] in
                    ("seresnet", "resnext", "seresnext", "senet"))


@pytest.mark.parametrize("name", _NEW_NAMES)
def test_int8_plan_walks_every_new_name(name):
    """Each of the 36 names at full size (under ``FakeTensorMode``: shapes,
    no data): the int8 pipeline walks its tree, every grouped conv has a
    per-group width the grouped K2 takes, SE units carry a gate and a K11
    scale, SENet's stem has its two K2 convs, and no unit chains onto K8."""
    family = get_constructor(name).__module__.rsplit(".", 1)[-1]
    with FakeTensorMode():
        model = get_constructor(name)().eval()
        scales = {n.replace(".", "/"): 2.0 for n, m in model.named_modules()
                  if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
        _, plan = prepare_int8_resnet(model, scales)
    assert len(_NEW_NAMES) == 36
    units = plan["units"]
    assert units and not any("chain" in u for u in units)
    assert all(("se" in u) == (family != "resnext") for u in units)
    assert all(("q" in u) == ("se" in u) for u in units)
    assert len(plan["stem_convs"]) == (2 if family == "senet" else 0)
    grouped = [st for u in units for st in u["body"] if st["groups"] > 1]
    assert len(grouped) == (0 if family == "seresnet" else len(units))
    for st in grouped:
        cout, _, _, cg = st["w"].shape
        assert cg in k2.GROUP_WIDTHS and (cout // st["groups"]) % 2 == 0


@pytest.mark.parametrize("name", ["resnext14_32x2d", "seresnet10",
                                  "seresnext50_32x4d", "senet16"])
def test_make_serving_fn_on_cpu(name):
    """The ``resnet`` route in mode auto, on the CPU at 32x32: logits of the
    declared shape, cosine >= 0.99 against the f32 reference forward."""
    serve = pt.make_serving_fn(name, (64, 64), device="cpu",
                               in_size=(32, 32))
    assert serve.route == "resnet"
    raw = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)
    y = serve(raw).to(torch.float32)
    yf = serve.make_reference_forward()(raw).to(torch.float32)
    assert tuple(y.shape) == (2, 1000) and bool(torch.isfinite(y).all())
    cos = float(torch.nn.functional.cosine_similarity(y.flatten(),
                                                      yf.flatten(), dim=0))
    assert cos >= 0.99, cos


# ---------------------------------------------------------------- K10

@pytest.mark.parametrize("h,w,c,n", [(60, 128, 128, 900), (12, 37, 24, 5),
                                     (40, 70, 96, 333)])
def test_patch_window_table_and_gather_bit_equal_to_fixed_order(h, w, c, n):
    """K10's table of distinct windows (each summed once, rows outer,
    columns inner, one f32 rounding an add) gathered by ``window_index``
    is bit-equal to each start's own fixed-order sum; within 1e-5 of the
    plain version and, at the tool's C 128, of its ``oracle``; n below and
    above the count of distinct windows."""
    g = torch.Generator().manual_seed(h + n)
    x = torch.randn((h, w, c), generator=g).to(torch.bfloat16)
    starts = torch.stack([torch.randint(-5, h + 5, (n,), generator=g),
                          torch.randint(-9, w + 9, (n,), generator=g)],
                         1).to(torch.int32)
    xf = x.to(torch.float32)

    def fixed_order(sy, sx):             # (k,) each -> (k, c)
        acc = torch.zeros((len(sy), c), dtype=torch.float32)
        for r in range(PATCH_ROWS):
            for col in range(PATCH_COLS):
                acc = acc + xf[sy + r, sx + col]
        return acc
    nx = -(-(w - PATCH_COLS) // 8) + 1
    k = torch.arange(distinct_windows(h, w))
    table = fixed_order(k // nx, torch.clamp(k % nx * 8, max=w - PATCH_COLS))
    got = table[window_index(starts, h, w)]
    sy, sx = clamped_starts(starts, h, w).unbind(1)
    assert torch.equal(got, fixed_order(sy, sx))
    ref = patch_window_sum_reference(x, starts)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if c == 128:                          # the tool's oracle fixes C
        want = np.asarray(_probe_tool().oracle(
            jnp.asarray(xf.numpy(), jnp.bfloat16),
            jnp.asarray(starts.numpy())))
        assert float(np.abs(got.numpy() - want).max()) <= \
            1e-5 * float(np.abs(want).max())


def _probe_tool():
    """``tools/exp_pallas_patch_probe.py`` as a module (its ``oracle``)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "exp_pallas_patch_probe.py")
    spec = importlib.util.spec_from_file_location("exp_pallas_patch_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
