"""The port's pose and detection slice against the JAX package: the new
blocks (the transposed conv block, square-channel included, the pixel
shuffle and DUC block, the dense SE gate, CenterNet's decoder unit and
heads), both decodes (``HeatmapMaxDetBlock`` and
``centernet_heatmap_max_det``) exact on constructed ties, SimplePose,
CenterNet and AlphaPose in f32 (64x48 pose, 128x128 CenterNet), the int8
plain ResNet trunk bit for bit against JAX ``prepare_int8_plain_trunk``
(resnet18's basic blocks, resnet50b's bottlenecks and a narrow
Fast-SE-ResNet trunk with SE units), and the ``pose`` and ``detection`` serving closures against their
f32 oracles, with the route each took against the JAX package's choice
(the tree checks' verdicts on the zoo's trees:
``test_torch_port_trunk_check.py``).

Weights are the port's seeded init with BN randomized, carried to JAX by
the JAX package's ``convert_state_dict`` (and back by
``load_jax_variables``: strict, so every JAX scope name must match).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp

import pytorchcv_tpu as ptc
from pytorchcv_tpu import nn as jnn
from pytorchcv_tpu.model import Model
from pytorchcv_tpu.models.alphapose_coco import AlphaPose as JaxAlphaPose
from pytorchcv_tpu.models.centernet import (
    CenterNetDecoderUnit as JaxDecoderUnit,
    CenterNetHeadBlock as JaxHeadBlock,
    CenterNetHeatmapBlock as JaxHeatmapBlock,
    centernet_heatmap_max_det as jax_centernet_decode)
from pytorchcv_tpu.models.fastseresnet import \
    fastseresnet_features as jax_fastseresnet_features
from pytorchcv_tpu.nn.base import Held
from pytorchcv_tpu.quant.seg_backbone_int8 import (
    is_plain_resnet_trunk as jax_is_plain_trunk,
    prepare_int8_plain_trunk as jax_prepare_trunk)
from pytorchcv_tpu.serve import declared_int8_route as jax_declared_route
from pytorchcv_tpu.zoo.convert import convert_state_dict
import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.model_provider import _init_weights
from pytorchcv_tpu_torch.models.alphapose_coco import AlphaPose
from pytorchcv_tpu_torch.models.centernet import (CenterNetDecoderUnit,
                                                  CenterNetHeadBlock,
                                                  CenterNetHeatmapBlock,
                                                  centernet_heatmap_max_det)
from pytorchcv_tpu_torch.models.fastseresnet import fastseresnet_features
from pytorchcv_tpu_torch.models.simplepose_coco import SimplePose, plain_trunk
from pytorchcv_tpu_torch.nn import (DeconvBlock, DucBlock, HeatmapMaxDetBlock,
                                    SEBlock, Sequential, positional_layers)
from pytorchcv_tpu_torch.quant import (UnsupportedTreeError, calibrate_int8,
                                       is_plain_resnet_trunk,
                                       prepare_int8_plain_trunk)
import pytorchcv_tpu_torch.quant.resnet_int8 as rq
from pytorchcv_tpu_torch.zoo import load_jax_variables

torch.set_num_threads(1)

_POSE = (64, 48)
_DET = (128, 128)
_BLOCK_TOL = 1e-5             # blocks: max |err| / max |out|
_MODEL_TOL = 1e-4             # whole models (dozens of layers deep)


def _randomize(tm, seed, exact=False):
    """BN statistics and affine from a seeded generator, in place. With
    ``exact``, every ``var + eps`` is 1/4, 1 or 4 (rsqrt exact, so both
    packages fold the same constants) and the 7x7 stem becomes exact in
    bf16 on a 1/4-grid input: kernel entries k/64 (|k| <= 16), its BN scale
    1 (the folded kernel k/64 * {2, 1, 1/2}), so the stem's products sum
    exactly in f32 in any order."""
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
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and \
                    m.bias is not None:
                m.bias.copy_(torch.from_numpy(
                    (rng.standard_normal(m.bias.shape) * 0.1)
                    .astype(np.float32)))
        if exact:
            stem = tm.backbone[0].conv
            stem.conv.weight.copy_(torch.from_numpy(
                rng.integers(-16, 17, stem.conv.weight.shape) / 64.0))
            stem.bn.weight.fill_(1.0)


def _twin(jm, tm):
    """``jm`` carrying ``tm``'s weights, loaded back into ``tm`` through
    ``load_jax_variables`` (strict)."""
    variables = convert_state_dict(tm.state_dict(), jm.shape_variables())
    load_jax_variables(tm, variables)
    return dataclasses.replace(jm, variables=jax.tree_util.tree_map(
        jnp.asarray, variables))


def _pair(name, hw, seed=1, exact=False, **kw):
    tm = pt.get_model(name, in_size=hw, device="cpu", **kw)
    _randomize(tm, seed, exact)
    return _twin(ptc.get_model(name, in_size=hw, init=False, **kw), tm), tm


def _grid_image(seed, hw, n=2):
    """NHWC f32 input on a 1/4 grid in [-2, 2] (exact in bf16)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (n, *hw, 3)) / 4.0).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _block_vs_jax(jmod, tmod, x, *args):
    """``tmod`` (BN randomized, eval) against ``jmod`` on its weights:
    (port NCHW output as NHWC numpy, JAX output)."""
    _randomize(tmod, 3)
    tmod.eval()
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), *args))
    variables = convert_state_dict(tmod.state_dict(), shapes)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), *args))
    with torch.inference_mode():
        got = tmod(_nchw(x), *args).numpy()
    return (got.transpose(0, 2, 3, 1) if got.ndim == 4 else got), want


# ---------------------------------------------------------------- blocks

@pytest.mark.parametrize("cin,cout", [(16, 16), (12, 8)])
def test_deconv_block_matches_jax(cin, cout):
    """4x4/2 transposed conv + BN + ReLU. At 16 -> 16 the kernel's (I, O)
    swap keeps the shape, so only the numbers can catch it."""
    x = np.random.default_rng(0).standard_normal((2, 5, 6, cin)).astype(
        np.float32)
    got, want = _block_vs_jax(jnn.DeconvBlock(out_channels=cout),
                              DeconvBlock(cin, cout), x)
    assert got.shape == want.shape == (2, 10, 12, cout)
    assert _rel(got, want) <= _BLOCK_TOL


def test_deconv_transposed_kernel_is_caught():
    """The same square-channel weights with I and O swapped give another
    output: the check above can see a swap."""
    x = np.random.default_rng(1).standard_normal((1, 4, 4, 16)).astype(
        np.float32)
    block = DeconvBlock(16, 16).eval()
    _randomize(block, 4)
    with torch.inference_mode():
        y = block(_nchw(x))
        block.conv.weight.copy_(block.conv.weight.transpose(0, 1).clone())
        z = block(_nchw(x))
    assert float((y - z).abs().max()) > 0.1 * float(y.abs().max())


def test_pixel_shuffle_and_duc_block_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 4, 24)).astype(np.float32)
    want = np.asarray(jnn.pixel_shuffle(jnp.asarray(x), 2))
    got = torch.nn.functional.pixel_shuffle(_nchw(x), 2).permute(
        0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    got, want = _block_vs_jax(jnn.DucBlock(out_channels=8, scale_factor=2),
                              DucBlock(24, 8, 2), x)
    assert got.shape == want.shape == (2, 6, 8, 8)
    assert _rel(got, want) <= _BLOCK_TOL


def test_dense_se_block_matches_jax():
    """Fast-SE-ResNet's gate: dense ``fc1``/``fc2``, reduction 1."""
    x = np.random.default_rng(3).standard_normal((2, 5, 4, 32)).astype(
        np.float32)
    got, want = _block_vs_jax(
        jnn.SEBlock(channels=32, reduction=1, use_conv=False),
        SEBlock(32, reduction=1, use_conv=False), x)
    assert _rel(got, want) <= _BLOCK_TOL


@pytest.mark.parametrize("which", ["unit", "head", "heatmap", "heatmap_nms"])
def test_centernet_blocks_match_jax(which):
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    jmod, tmod = {
        "unit": (JaxDecoderUnit(out_channels=8), CenterNetDecoderUnit(16, 8)),
        "head": (JaxHeadBlock(out_channels=5), CenterNetHeadBlock(16, 5)),
        "heatmap": (JaxHeatmapBlock(out_channels=5, do_nms=False),
                    CenterNetHeatmapBlock(16, 5, do_nms=False)),
        "heatmap_nms": (JaxHeatmapBlock(out_channels=5, do_nms=True),
                        CenterNetHeatmapBlock(16, 5, do_nms=True))}[which]
    got, want = _block_vs_jax(jmod, tmod, x)
    assert got.shape == want.shape
    assert _rel(got, want) <= _BLOCK_TOL
    if which == "heatmap_nms":      # the suppression zeroes most pixels
        np.testing.assert_array_equal(got == 0, want == 0)
        assert 0.5 < float((want == 0).mean()) < 0.99


# ---------------------------------------------------------------- decodes

def _tied_heatmaps(dtype):
    """(B, H, W, K) maps on a coarse grid, full of ties, with: two equal
    maxima (map 0), an all-negative map (map 1), a maximum on the border
    (map 2), a maximum between equal neighbours (map 3), a zero map
    (map 4)."""
    rng = np.random.default_rng(5)
    hm = (rng.integers(-3, 4, (2, 7, 6, 5)) / 4.0).astype(np.float32)
    hm[:, :, :, 0] = np.minimum(hm[:, :, :, 0], 0.5)
    hm[:, 2, 3, 0] = hm[:, 4, 1, 0] = 1.5
    hm[:, :, :, 1] = -np.abs(hm[:, :, :, 1]) - 0.25
    hm[:, 0, 2, 2] = 2.0
    hm[:, 3, 2, 3] = 2.0
    hm[:, 3, 1, 3] = hm[:, 3, 3, 3] = 1.0
    hm[:, :, :, 4] = 0.0
    return np.asarray(jnp.asarray(hm, dtype).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heatmap_max_det_exact_on_ties(dtype):
    hm = _tied_heatmaps(dtype)
    want = np.asarray(jnn.HeatmapMaxDetBlock().apply(
        {}, jnp.asarray(hm, getattr(jnp, dtype))).astype(jnp.float32))
    got = HeatmapMaxDetBlock()(_nchw(hm).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    # the first of two equal maxima: (x 3, y 2), not (1, 4)
    assert (np.abs(want[:, 0, :2] - [3, 2]) <= 0.25).all()
    assert (want[:, 1, :2] == 0).all()               # no maximum above 0
    assert (want[:, 2, :2] == [2, 0]).all()          # border: no shift
    assert (want[:, 3, 0] == 2).all()                # equal neighbours
    assert (want[:, 4] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_centernet_decode_exact_on_ties(dtype):
    """3 classes on an 8x8 grid of four score levels: every top-40 slot
    past the first few is a tie, ranked by the lower flat index as
    ``jax.lax.top_k`` ranks it."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 7)).astype(np.float32)
    x[..., :3] = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), (2, 8, 8, 3))
    x = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
    want = np.asarray(jax_centernet_decode(jnp.asarray(x, dtype)))
    got = centernet_heatmap_max_det(_nchw(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    # torch.topk may order equal scores otherwise: the decode must not.
    scores = want[:, :, 5]
    assert (np.diff(scores, axis=1) == 0).sum() > 30


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("name,hw,kw", [
    ("simplepose_resnet18_coco", _POSE, {"return_heatmap": True}),
    ("simplepose_resnet50b_coco", _POSE, {"return_heatmap": True}),
    ("centernet_resnet18_voc", _DET, {"return_heatmap": True}),
    ("centernet_resnet18_voc", _DET, {}),
    ("alphapose_fastseresnet101b_coco", _POSE, {"return_heatmap": True})])
def test_f32_model_matches_jax(name, hw, kw):
    jm, tm = _pair(name, hw, **kw)
    x = np.random.default_rng(7).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(_nchw(x)).numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _rel(got, want) <= _MODEL_TOL


# ---------------------------------------------------------------- int8 trunk

def _jax_trunk(jm, scales, x):
    """JAX's plain trunk with XLA's fusion pass off, so that every op rounds
    as written (fused, XLA:CPU turns acc * A + B into one FMA)."""
    fn, qtree = jax_prepare_trunk(jm, scales)
    return np.asarray(jax.jit(fn).lower(qtree, jnp.asarray(x)).compile(
        {"xla_disable_hlo_passes": "fusion"})(qtree, jnp.asarray(x))
        .astype(jnp.float32))


@pytest.mark.parametrize("name", ["simplepose_resnet18_coco",
                                  "simplepose_resnet50b_coco"])
def test_int8_plain_trunk_bit_exact_vs_jax(name):
    """Basic blocks (stride at conv1) and bottlenecks (stride at the 3x3):
    K3's 7x7 stem, ``maxpool_i8`` and every unit on K2, bit for bit."""
    jm, tm = _pair(name, _POSE, exact=True, return_heatmap=True)
    x = _grid_image(8, _POSE)
    scales = calibrate_int8(tm, [_nchw(_grid_image(9, _POSE, n=4))])
    want = _jax_trunk(jm, scales, x)
    infer, plan = prepare_int8_plain_trunk(tm, scales)
    assert not plan["stem_convs"] and not any(u["bend"]
                                              for u in plan["units"])
    assert len(plan["units"]) == (8 if "18" in name else 16)
    got = infer(plan, _nchw(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    assert (want > 0).mean() > 0.1


_SE_CHANNELS = [[64, 64], [128], [256], [512]]


def _se_trunk_pair():
    """A narrow AlphaPose: Fast-SE-ResNet trunk of ``_SE_CHANNELS`` (SE on
    unit 1 of each stage, dense, reduction 1), decoder widths (32, 16)."""
    feats = fastseresnet_features(_SE_CHANNELS, 64, True, False,
                                  final_pool=False)
    tm = AlphaPose(Sequential(positional_layers(feats.named_children())),
                   512, channels=(32, 16), return_heatmap=True,
                   in_size=_POSE)
    _init_weights(tm, 0)
    tm.eval()
    _randomize(tm, 1, exact=True)
    jfeats = jax_fastseresnet_features(_SE_CHANNELS, 64, True, False,
                                       final_pool=False)
    layers = [l.module if isinstance(l, Held) else l for l in jfeats.layers]
    jbb = jnn.Sequential(layers=jnn.positional_layers(layers),
                         name="backbone", parent=None)
    jm = Model(name="alphapose_narrow", module=JaxAlphaPose(
        backbone=jbb, backbone_out_channels=512, channels=[32, 16],
        return_heatmap=True, in_size=_POSE))
    return _twin(jm, tm), tm


def _jax_gate(t, k1, b1, k2, b2):
    """JAX ``_se_gate``'s gate of ``t``, computed by the JAX package's ops
    (its f32 mean over H and W, its two products): the port's tail handed
    JAX's gate."""
    p = jnp.mean(jnp.asarray(t.to(torch.float32).numpy()), axis=(1, 2),
                 keepdims=True)
    h = jnp.maximum(jnp.einsum("bijc,cm->bijm", p, jnp.asarray(k1.numpy()))
                    + jnp.asarray(b1.numpy()), 0.0)
    g = jax.nn.sigmoid(jnp.einsum("bijm,mc->bijc", h,
                                  jnp.asarray(k2.numpy()))
                       + jnp.asarray(b2.numpy()))
    return torch.from_numpy(np.array(g[:, 0, 0, :]))


def test_int8_se_trunk_bit_exact_vs_jax(monkeypatch):
    """SE units in the plain trunk (AlphaPose's): the last conv to bf16 on
    K2, the gate, the tail on K11. Handed JAX's gate the trunk is bit-exact
    (the squeeze's f32 mean and the gate's products sum in another order
    than XLA's); on its own gate within cosine 0.999."""
    jm, tm = _se_trunk_pair()
    x = _grid_image(10, _POSE)
    scales = calibrate_int8(tm, [_nchw(_grid_image(11, _POSE, n=4))])
    want = _jax_trunk(jm, scales, x)
    infer, plan = prepare_int8_plain_trunk(tm, scales)
    assert [("se" in u) for u in plan["units"]] == [True, False, True, True,
                                                    True]
    own = infer(plan, _nchw(x)).to(torch.float32).numpy()
    cos = float((own * want).sum() / (np.linalg.norm(own) *
                                      np.linalg.norm(want)))
    assert cos >= 0.999, cos
    monkeypatch.setattr(rq, "se_gate", _jax_gate)
    got = infer(plan, _nchw(x)).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_trunk_refuses_a_stride_off_its_geometry():
    """A bottleneck built with ``conv1_stride=True`` passes the tree check
    (JAX's too, which does not read strides) but its stride sits on conv1,
    where the JAX trunk would move it to the 3x3: the port raises."""
    with FakeTensorMode():
        tm = SimplePose(plain_trunk(50, conv1_stride=True), 2048).eval()
        scales = {n.replace(".", "/"): 2.0 for n, m in tm.named_modules()
                  if isinstance(m, torch.nn.Conv2d)}
        assert is_plain_resnet_trunk(tm)
        with pytest.raises(UnsupportedTreeError,
                           match="2/unit1/body/conv1.*geometry"):
            prepare_int8_plain_trunk(tm, scales)


# ---------------------------------------------------------------- serving

def _jax_route(name, task, mode):
    """The pipeline the JAX package's ``make_serving_fn`` takes for
    ``name`` (``serve.py:235-344``): its declared route where the tree
    passes the route's check and the head takes ``from_features``, the
    generic int8 interception in mode int8, else bf16."""
    jm = ptc.get_model(name, init=False)
    route = jax_declared_route(name, mode) if mode != "bf16" else None
    head_ok = "from_features" in inspect.signature(
        type(jm.module).__call__).parameters
    if route == "plain_trunk" and task in ("pose", "detection") and \
            head_ok and jax_is_plain_trunk(jm.shape_variables()):
        return route
    return "generic int8" if mode == "int8" else "bf16"


def _cos(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return float((a * b).sum() / (a.norm() * b.norm()))


@pytest.mark.parametrize("name,task,hw,src,mode", [
    ("simplepose_resnet18_coco", "pose", _POSE, (80, 60), "auto"),
    ("simplepose_resnet50b_coco", "pose", _POSE, (80, 60), "int8"),
    ("simplepose_resnet50b_coco", "pose", _POSE, (80, 60), "bf16"),
    ("alphapose_fastseresnet101b_coco", "pose", _POSE, (80, 60), "auto"),
    ("centernet_resnet18_voc", "detection", _DET, (120, 160), "auto"),
    ("centernet_resnet50b_coco", "detection", _DET, (120, 160), "bf16")])
def test_serving_matches_reference_forward(name, task, hw, src, mode):
    """The closure with ``return_heatmap`` (the pre-decode tensor) against
    its f32 oracle at cosine >= 0.99, on the route the JAX package takes;
    a closure built again without ``return_heatmap`` (the same calibration
    and plan) returns the decode of that tensor."""
    model = pt.get_model(name, in_size=hw, device="cpu",
                         return_heatmap=True)
    _randomize(model, 12)
    serve = pt.make_serving_fn(name, src, mode=mode, task=task,
                               device="cpu", model=model)
    assert serve.route == _jax_route(name, task, mode)
    assert (serve.head is None) == (serve.route == "bf16")
    raw = np.random.default_rng(13).integers(0, 256, (2, *src, 3),
                                             dtype=np.uint8)
    y = serve(raw)
    ref = serve.make_reference_forward()(raw)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == tuple(ref.shape)
    assert bool(torch.isfinite(y.float()).all())
    assert _cos(y, ref) >= 0.99, _cos(y, ref)
    model.return_heatmap = False
    dec = pt.make_serving_fn(name, src, mode=mode, task=task, device="cpu",
                             model=model)(raw)
    if task == "pose":
        assert torch.equal(dec, HeatmapMaxDetBlock()(y))
    else:
        assert dec.dtype == torch.float32 and tuple(dec.shape) == (2, 40, 6)
        assert bool(torch.isfinite(dec).all())


def test_serving_without_a_route_raises_in_int8():
    """Fast-SE-ResNet declares no int8 route: mode int8 would take the JAX
    package's generic interception, which the port does not have."""
    assert _jax_route("fastseresnet101b", "classification", "int8") == \
        "generic int8"
    with pytest.raises(NotImplementedError, match="no int8 pipeline"):
        pt.make_serving_fn("fastseresnet101b", (64, 64), mode="int8",
                           device="cpu", in_size=(32, 32))
    serve = pt.make_serving_fn("fastseresnet101b", (64, 64), device="cpu",
                               in_size=(32, 32))
    assert serve.route == "bf16" and serve.head is None


def test_dense_route_falls_back_to_bf16():
    """As the JAX package's ``make_serving_fn`` decides
    (``serve.py:259-266``): a head whose forward takes no
    ``from_features``, or a trunk that fails ``is_plain_resnet_trunk`` (a
    unit with ResNet-A's ``identity_block``), is served in bf16 in mode
    auto; mode int8 raises (the generic interception is not ported)."""
    class NoFeatures(SimplePose):
        def forward(self, x):
            return super().forward(x)

    def headless():
        m = pt.get_model("simplepose_resnet18_coco", in_size=_POSE,
                         device="cpu")
        m.__class__ = NoFeatures
        return m

    def extra_branch():
        m = pt.get_model("simplepose_resnet18_coco", in_size=_POSE,
                         device="cpu")
        m.backbone[2].unit1.identity_block = torch.nn.Conv2d(2, 2, 1)
        return m

    for make in (headless, extra_branch):
        model = make()
        serve = pt.make_serving_fn("simplepose_resnet18_coco", (80, 60),
                                   task="pose", device="cpu", model=model)
        assert serve.route == "bf16" and serve.head is None
        with pytest.raises(NotImplementedError, match="plain_trunk"):
            pt.make_serving_fn("simplepose_resnet18_coco", (80, 60),
                               mode="int8", task="pose", device="cpu",
                               model=model)
