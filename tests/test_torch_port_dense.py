"""The port's segmentation heads against the JAX package at 64x64: the new
blocks (``Concurrent`` with ``nn.Identity``, JAX's ``adaptive_avg_pool2d``
against ``nn.AdaptiveAvgPool2d`` at bins
that do not divide the map, PSPNet's pooling branches and final block,
DeepLabv3's ASPP), PSPNet, DeepLabv3 and FCN-8s(d) in f32 (main and aux
maps), the int8 segmentation backbone's bend read through a PSPNet head
(bit for bit against JAX ``prepare_int8_seg_backbone`` on an exact stem,
and through the served aux map), and the ``segmentation`` serving closures
in modes auto, int8 and bf16 against their f32 oracles, with the route
each took against the JAX package's choice.

Weights are the port's seeded init with BN randomized, carried to JAX by
the JAX package's ``convert_state_dict`` (and back by
``load_jax_variables``: strict, so PSPNet's ``pool.branches`` scope must
nest as the port's ``pool`` -> ``branches``).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu import nn as jnn
from pytorchcv_tpu.models.deeplabv3 import \
    AtrousSpatialPyramidPooling as JaxASPP
from pytorchcv_tpu.models.pspnet import (PSPFinalBlock as JaxPSPFinalBlock,
                                         PyramidPooling as JaxPyramidPooling,
                                         PyramidPoolingBranch as JaxPPBranch)
from pytorchcv_tpu.quant.seg_backbone_int8 import (
    is_seg_resnetd_backbone as jax_is_seg_backbone,
    prepare_int8_seg_backbone as jax_prepare_seg)
from pytorchcv_tpu.serve import declared_int8_route as jax_declared_route
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels.preprocess import segmentation_preprocess
from pytorchcv_tpu_torch.models.deeplabv3 import AtrousSpatialPyramidPooling
from pytorchcv_tpu_torch.models.pspnet import (PSPFinalBlock, PyramidPooling,
                                               PyramidPoolingBranch)
from pytorchcv_tpu_torch.quant import calibrate_int8, prepare_int8_seg_backbone
from pytorchcv_tpu_torch.serve import as_bfloat16
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_SIZE = (64, 64)
_SRC = (75, 100)               # a 375x500 VOC frame at a fifth
_BLOCK_TOL = 1e-5              # blocks: max |err| / max |out|
_MODEL_TOL = 1e-4              # whole models (dozens of layers deep)


def _randomize(tm, seed, exact=False):
    """BN statistics and affine from a seeded generator, in place. With
    ``exact``, every ``var + eps`` is 1/4, 1 or 4 (rsqrt exact, so both
    packages fold the same constants) and the deep stem's 3x3 conv1 is
    exact in bf16 on a 1/4-grid input (kernel k/64, |k| <= 16, BN scale
    1)."""
    rng = np.random.default_rng(seed)
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
                var = rng.choice(np.float32([0.25, 1.0, 4.0]), c) - \
                    np.float32(1e-5) if exact else \
                    rng.uniform(0.5, 2.0, c).astype(np.float32)
                m.running_var.copy_(torch.from_numpy(var))
        if exact:
            stem = tm.backbone[0].conv1
            stem.conv.weight.copy_(torch.from_numpy(
                rng.integers(-16, 17, stem.conv.weight.shape) / 64.0))
            stem.bn.weight.fill_(1.0)


def _pair(name, seed=1, exact=False, **kw):
    """The port model and its JAX twin on the same weights, loaded back into
    the port model through ``load_jax_variables`` (strict)."""
    tm = pt.get_model(name, in_size=_SIZE, device="cpu", **kw)
    _randomize(tm, seed, exact)
    jm = ptc.get_model(name, in_size=_SIZE, init=False, **kw)
    variables = convert_state_dict(tm.state_dict(), jm.shape_variables())
    load_jax_variables(tm, variables)
    return dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables)), tm


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).to(torch.float32).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _block_vs_jax(jmod, tmod, x, *args):
    """``tmod`` (BN randomized, eval) against ``jmod`` on its weights:
    (port output as NHWC numpy, JAX output)."""
    _randomize(tmod, 3)
    tmod.eval()
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), *args))
    variables = convert_state_dict(tmod.state_dict(), shapes)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), *args))
    with torch.inference_mode():
        got = _nhwc(tmod(_nchw(x), *args))
    return got, want


# ---------------------------------------------------------------- blocks

@pytest.mark.parametrize("hw,bins", [((8, 8), 3), ((8, 8), 6),
                                     ((7, 10), 3), ((8, 8), 2)])
def test_adaptive_avg_pool_windows_match_jax(hw, bins):
    """JAX's windows ``[floor(i m / n), ceil((i + 1) m / n))`` are
    ``nn.AdaptiveAvgPool2d``'s, the port's pool: at 8 -> 3 and 6 (and
    7x10 -> 3) they overlap, at 8 -> 2 they tile."""
    x = np.random.default_rng(0).standard_normal((2, *hw, 5)).astype(
        np.float32)
    want = np.asarray(jnn.adaptive_avg_pool2d(bins)(jnp.asarray(x)))
    got = _nhwc(torch.nn.AdaptiveAvgPool2d(bins)(_nchw(x)))
    assert got.shape == want.shape == (2, bins, bins, 5)
    assert _rel(got, want) <= _BLOCK_TOL


def test_pyramid_pooling_branches_match_jax():
    """``Concurrent`` of ``nn.Identity`` and the four pooled branches (1, 2, 3
    and 6 bins over an 8x8 map), concatenated on channels."""
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    got, want = _block_vs_jax(JaxPyramidPooling(16, (8, 8)),
                              PyramidPooling(16, (8, 8)).branches, x)
    assert got.shape == want.shape == (2, 8, 8, 32)
    np.testing.assert_array_equal(got[..., :16], x)
    assert _rel(got, want) <= _BLOCK_TOL


@pytest.mark.parametrize("upscale", [(8, 8), None])
def test_pyramid_pooling_branch_matches_jax(upscale):
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    got, want = _block_vs_jax(
        JaxPPBranch(out_channels=4, pool_out_size=3,
                    upscale_out_size=upscale),
        PyramidPoolingBranch(16, 4, 3, upscale), x)
    assert got.shape == want.shape == (2, 8, 8, 4)
    assert _rel(got, want) <= _BLOCK_TOL


def test_final_block_matches_jax():
    """3x3 block, 1x1 conv, bilinear (align corners) up to 64x64."""
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 32)).astype(
        np.float32)
    got, want = _block_vs_jax(
        JaxPSPFinalBlock(out_channels=5, bottleneck_factor=4),
        PSPFinalBlock(32, 5, 4), x, (64, 64))
    assert got.shape == want.shape == (2, 64, 64, 5)
    assert _rel(got, want) <= _BLOCK_TOL


def test_aspp_matches_jax():
    """Atrous 3x3 branches at rates 12, 24 and 36 (wider than the 8x8 map:
    most taps read padding), the global branch, the projection."""
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 64)).astype(
        np.float32)
    got, want = _block_vs_jax(JaxASPP(in_channels=64,
                                      upscale_out_size=(8, 8)),
                              AtrousSpatialPyramidPooling(64, (8, 8)), x)
    assert got.shape == want.shape == (2, 8, 8, 8)
    assert _rel(got, want) <= _BLOCK_TOL


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("name,aux", [("pspnet_resnetd50b_voc", True),
                                      ("pspnet_resnetd50b_ade20k", False),
                                      ("deeplabv3_resnetd50b_voc", True),
                                      ("fcn8sd_resnetd50b_coco", True)])
def test_f32_model_matches_jax(name, aux):
    jm, tm = _pair(name, aux=aux)
    assert tm.reads_bend == aux
    x = np.random.default_rng(5).standard_normal((2, *_SIZE, 3)).astype(
        np.float32)
    want = jm(jnp.asarray(x))
    with torch.inference_mode():
        got = tm(_nchw(x))
    want = want if aux else (want,)
    got = got if aux else (got,)
    assert len(got) == len(want) == (2 if aux else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert _nhwc(g).shape == w.shape == (2, *_SIZE, tm.num_classes)
        assert _rel(_nhwc(g), w) <= _MODEL_TOL


def _grid_image(seed, n=2):
    """NHWC f32 input on a 1/4 grid in [-2, 2] (exact in bf16)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (n, *_SIZE, 3)) / 4.0).astype(np.float32)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_bend_bit_exact_and_read_by_the_pspnet_head():
    """The int8 backbone's stage 4 and stage-3 bend bit for bit against
    JAX's (the bend written by K2 in the launch of stage 3's last unit);
    the port's bf16 head on them against the JAX package's bf16 head
    (``as_bfloat16``, ``from_features=True``) on JAX's: main and aux maps
    at cosine >= 0.999 (bf16 convs sum in another order)."""
    jm, tm = _pair("pspnet_resnetd50b_voc", exact=True)
    x = _grid_image(6)
    scales = calibrate_int8(tm, [_nchw(_grid_image(7, n=4))])
    fn, qtree = jax_prepare_seg(jm, scales)
    ref4, ref3 = jax.jit(fn).lower(qtree, jnp.asarray(x)).compile(
        {"xla_disable_hlo_passes": "fusion"})(qtree, jnp.asarray(x))
    infer, plan = prepare_int8_seg_backbone(tm, scales)
    assert [u["bend"] for u in plan["units"]].count(True) == 1
    got4, got3 = infer(plan, _nchw(x))
    np.testing.assert_array_equal(got4.to(torch.float32).numpy(),
                                  np.asarray(ref4.astype(jnp.float32)))
    np.testing.assert_array_equal(got3.to(torch.float32).numpy(),
                                  np.asarray(ref3.astype(jnp.float32)))
    jbf = jm.as_bfloat16()
    want = jbf.module.apply(jbf.variables, (ref4, ref3), train=False,
                            from_features=True)
    head = as_bfloat16(tm, without=tm.backbone)
    with torch.inference_mode():
        got = head((got4.permute(0, 3, 1, 2), got3.permute(0, 3, 1, 2)),
                   from_features=True)
    for g, w in zip(got, want):
        c = _cos(_nhwc(g), np.asarray(w.astype(jnp.float32)))
        assert c >= 0.999, c


@pytest.mark.parametrize("aux", [True, False])
def test_served_aux_map_reads_the_bend(aux):
    """The served closure's aux map is the head's aux block on the bend the
    int8 backbone writes for the served input (and the main map its final
    block on stage 4); without ``aux`` the plan writes no bend and the K2
    launches stay the same."""
    model = pt.get_model("pspnet_resnetd50b_voc", in_size=_SIZE,
                         device="cpu", aux=aux)
    _randomize(model, 8)
    serve = pt.make_serving_fn("pspnet_resnetd50b_voc", _SRC,
                               task="segmentation", device="cpu",
                               model=model)
    raw = np.random.default_rng(9).integers(0, 256, (2, *_SRC, 3),
                                            dtype=np.uint8)
    maps = serve(raw)
    x = segmentation_preprocess(_SIZE, _SRC, layout="nchw", device="cpu")(
        torch.from_numpy(raw))
    infer, plan = prepare_int8_seg_backbone(model, serve.scales, bend=aux)
    assert sum(u["bend"] for u in plan["units"]) == int(aux)
    with torch.inference_mode():
        out4, bend = infer(plan, x)
        assert (bend is None) != aux
        main = serve.head.final_block(serve.head.pool(
            out4.permute(0, 3, 1, 2)), _SIZE)
        if aux:
            assert torch.equal(maps[1], serve.head.aux_block(
                bend.permute(0, 3, 1, 2), _SIZE))
    assert torch.equal(maps[0] if aux else maps, main)


# ---------------------------------------------------------------- serving

def _jax_route(name, mode):
    """The pipeline the JAX package's ``make_serving_fn(...,
    task="segmentation")`` takes (``serve.py:238-344``): ``seg_backbone``
    where it is declared, the tree passes its check and the head takes
    ``from_features``; the generic int8 interception in mode int8; else
    bf16."""
    jm = ptc.get_model(name, init=False)
    route = jax_declared_route(name, mode) if mode != "bf16" else None
    head_ok = "from_features" in inspect.signature(
        type(jm.module).__call__).parameters
    if route == "seg_backbone" and head_ok and \
            jax_is_seg_backbone(jm.shape_variables()):
        return route
    return "generic int8" if mode == "int8" else "bf16"


def _served_model(name):
    """The model a serving case serves, and its source frame and seed: the
    seg heads at 64x64 with BN randomized (``_randomize``), every alpha
    drawn as U(0.5, 1.5); DANet on the draw of
    tests/test_torch_port_seg.py's serving gate (default BN, 96x96 from
    104x128, alphas +-U(0.5, 1.5)), held to that gate's share of decisive
    pixels, more than 90 % (the seg heads' draw: more than 80 %)."""
    g = torch.Generator().manual_seed(1)
    if "danet" in name:
        model = pt.get_model(name, in_size=(96, 96), rng=0, device="cpu")
        with torch.no_grad():
            for m in model.modules():
                if hasattr(m, "alpha"):
                    mag = torch.empty(1).uniform_(0.5, 1.5, generator=g)
                    m.alpha.copy_(mag if float(torch.rand(1, generator=g))
                                  < 0.5 else -mag)
        return model, (104, 128), 9, 0.9
    model = pt.get_model(name, in_size=_SIZE, device="cpu")
    _randomize(model, 10)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "alpha"):
                m.alpha.copy_(torch.empty(1).uniform_(0.5, 1.5, generator=g))
    return model, _SRC, 11, 0.8


@pytest.mark.parametrize("name,mode", [
    ("pspnet_resnetd50b_voc", "auto"), ("pspnet_resnetd50b_voc", "bf16"),
    ("deeplabv3_resnetd50b_voc", "int8"), ("deeplabv3_resnetd50b_voc", "bf16"),
    ("fcn8sd_resnetd50b_voc", "auto"), ("danet_resnetd50b_cityscapes", "bf16"),
    ("danet_resnetd50b_cityscapes", "int8")])
def test_serving_matches_reference_forward(name, mode):
    """Every map against the f32 oracle: cosine >= 0.99 and, on the pixels
    whose f32 top-2 margin is decisive (> 2 % of the largest logit; random
    weights leave near-ties whose argmax the summation order flips), argmax
    agreement >= 0.97 (the gate of tests/test_quant.py:399-400), on the
    route the JAX package takes, with at least the draw's share of every
    map's pixels decisive (``_served_model``)."""
    model, src, seed, share = _served_model(name)
    serve = pt.make_serving_fn(name, src, mode=mode, task="segmentation",
                               device="cpu", model=model)
    assert serve.route == _jax_route(name, mode)
    assert (serve.head is None) == (serve.route == "bf16")
    raw = np.random.default_rng(seed).integers(0, 256, (2, *src, 3),
                                               dtype=np.uint8)
    maps, ref = serve(raw), serve.make_reference_forward()(raw)
    assert len(maps) == len(ref) == (3 if "danet" in name else 2)
    for y, yf in zip(maps, ref):
        assert y.dtype == torch.bfloat16 and y.shape == yf.shape
        assert tuple(y.shape[2:]) == tuple(model.in_size)
        assert bool(torch.isfinite(y.float()).all())
        y = y.float()
        top2 = yf.topk(2, dim=1).values
        decisive = (top2[:, 0] - top2[:, 1]) / yf.abs().amax(dim=1) > 0.02
        agree = float((y.argmax(1) == yf.argmax(1))[decisive].float().mean())
        c = _cos(y.numpy(), yf.numpy())
        assert float(decisive.float().mean()) > share
        assert c >= 0.99, c
        assert agree >= 0.97, agree
