"""The port's CUDA kernels against their plain PyTorch versions on shapes
the serving paths do not give them: partial output tiles, reduction tails,
odd image sizes, dilations on odd sizes, narrow models, the bf16 residual
of a last unit with an identity conv, attention at sequence lengths and
widths no tile divides, the deformable sampler (K5) at widths that are not
multiples of 8, with windows across every border and element counts no
block divides, with x NCHW and channels-last at RFC's and the generator's
shapes, at C/G no 16-byte vector divides, with more groups than a tile
stages and on an unaligned view, and the depthwise conv (K6) at odd sizes,
asymmetric pads,
planes no block divides and every activation, at every depthwise call of
EfficientNet-B0 and -B0b, under forced plans and on an unaligned view, and
an f32 EfficientNet-B0 under bf16 and f16 autocast, ``maxpool_i8`` under
every vector width and row run and on unaligned views, the window
attention (K7)
at head widths, lengths and masks off ProPainter's path, a narrow
ProPainter generator on the card against the CPU, the fused bottleneck
chain (K8) at odd maps, ragged row tiles and WRN-50-2's widest stage, the
int8 stem (K9) at odd sizes and at 224 -> 112 with O 64, 8 and 40 and
after writes through ``.data``, the
window-sum probe (K10) at odd sizes, the grouped K2 under every grouped
tile at ragged pixel and channel tiles, RAFT (no kernel of ours) against
the CPU and its two correlation lookups against each other,
``ProPainterIterator`` from frames and masks against the CPU, the ResNet-50
logits with and without K8 chains, DANet's position-attention gradients
against the CPU's and a direct f32 forward under torch's TF32 defaults;
K2 under each of its block tiles at sizes no tile divides, and K3 at the
paths' stem shapes; the int8 MobileNet v1 and v2 routes (launch counts,
every K12 and K2 call bit-exact, K3 with ReLU6), the int8 depthwise conv
(K12) at odd shapes, C 20, 6 and 7 and every act under every instance,
row band and block size, K2's ReLU6, linear-residual and f32-output
epilogues, and K6 at every depthwise call of a bf16
MobileNetV3-large; no K2, K3, K5, K6, K9, K12 or ``maxpool_i8`` instance
spills.

Each test carries the ``cuda`` marker, needs a CUDA card and nvcc, and
skips without a card. On a machine without JAX, run them without the
suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_port_cuda.py
"""

import copy
import itertools

import numpy as np
import pytest
import torch

import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from pytorchcv_tpu_torch.kernels._build import no_tf32
from pytorchcv_tpu_torch.kernels.attention import (
    fused_window_attention, fused_window_attention_reference)
from pytorchcv_tpu_torch.kernels.deform_patch import (deform_sample,
                                                      deform_sample_reference)
from pytorchcv_tpu_torch.kernels.dwconv import (ACTIVATIONS, dwconv2d_bn_act,
                                                dwconv2d_bn_act_reference)
from pytorchcv_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                   int8_conv_reference)
from pytorchcv_tpu_torch.kernels.preprocess import (
    _pil_bilinear_matrix, bf16_ulp_distance, bf16_ulp_error,
    classification_preprocess, preprocess, preprocess_reference,
    resize_bands, resize_matrices)
from pytorchcv_tpu_torch.kernels.stem import (maxpool_i8, maxpool_i8_reference,
                                              stem_conv, stem_conv_reference)
from pytorchcv_tpu_torch.nn.deform import deform_conv2d
from pytorchcv_tpu_torch.quant import calibrate_int8, prepare_int8_resnet
from pytorchcv_tpu_torch.serve import as_bfloat16

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _i8(rng, shape, dev):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)
                            ).to(dev)


@pytest.mark.parametrize("k,stride,cin,cout,hw", [
    (3, 2, 12, 24, 9), (1, 1, 36, 72, 5), (3, 1, 260, 20, 6),
    (1, 2, 4, 130, 11)])
def test_int8_conv_kernel_matches_plain(k, stride, cin, cout, hw):
    dev = _cuda()
    rng = np.random.default_rng(k * 1000 + cin)
    x = _i8(rng, (3, hw, hw, cin), dev)
    w = _i8(rng, (cout, k, k, cin), dev)
    a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    ho = (hw + 2 * (k // 2) - k) // stride + 1
    res_i8 = _i8(rng, (3, ho, ho, cout), dev)
    res_bf = torch.from_numpy(rng.standard_normal((3, ho, ho, cout)).astype(
        np.float32)).to(dev, torch.bfloat16)
    cases = [dict(act="relu", q=0.7), dict(act=None, q=0.7),
             dict(act="relu"), dict(act=None),
             dict(act=None, q=0.7, residual=res_i8, res_scale=0.01,
                  round_res=True),
             dict(act=None, q=0.7, residual=res_i8, res_scale=0.01),
             dict(act=None, residual=res_bf)]
    for kw in cases:
        got = int8_conv(x, w, a, b, stride, **kw)
        ref = int8_conv_reference(x, w, a, b, stride, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (kw.keys(), (got.float() - ref.float())
                                       .abs().max())


@pytest.mark.parametrize("dilation,hw", [(2, 9), (4, 13), (2, 7)])
def test_int8_conv_dilated_kernel_matches_plain(dilation, hw):
    dev = _cuda()
    rng = np.random.default_rng(dilation * 100 + hw)
    x = _i8(rng, (2, hw, hw + 2, 20), dev)
    w = _i8(rng, (70, 3, 3, 20), dev)
    a = torch.from_numpy(rng.uniform(2e-5, 2e-4, 70).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.standard_normal(70).astype(np.float32)).to(dev)
    res = _i8(rng, (2, hw, hw + 2, 70), dev)
    for kw in (dict(act="relu", q=0.7), dict(act=None),
               dict(act=None, q=0.7, residual=res, res_scale=0.01,
                    round_res=True, bend=True)):
        got = int8_conv(x, w, a, b, 1, dilation=dilation, **kw)
        ref = int8_conv_reference(x, w, a, b, 1, dilation=dilation, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g_, r_ in zip(got, ref):
            assert torch.equal(g_, r_), (kw.keys(), (g_.float() - r_.float())
                                         .abs().max())


@pytest.mark.parametrize("cin", [32, 20])
@pytest.mark.parametrize("tile", [(128, 128), (128, 64), (64, 128),
                                  (64, 64)])
def test_int8_conv_every_tile_matches_plain(tile, cin):
    """Each of K2's block tiles, forced, at M = 3 x 11 x 13 = 429 pixels
    and Cout 200 (neither a multiple of any tile), 3x3 stride 1 and 1x1
    stride 2, with 16-byte (Cin 32) and 4-byte (Cin 20) copies, every
    residual mode and the bend: bit-exact against the plain version."""
    from pytorchcv_tpu_torch.kernels import int8_conv as k2
    dev = _cuda()
    rng = np.random.default_rng(tile[0] + tile[1] + cin)
    cout = 200
    a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    for k, stride, hw in ((3, 1, (11, 13)), (1, 2, (21, 25))):
        x = _i8(rng, (3, *hw, cin), dev)
        w = _i8(rng, (cout, k, k, cin), dev)
        shape = (3, 11, 13, cout)
        res_i8 = _i8(rng, shape, dev)
        res_bf = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)
        for kw, mode in ((dict(act="relu", q=0.7), k2._RES_NONE),
                         (dict(act=None), k2._RES_NONE),
                         (dict(act=None, q=0.7, residual=res_i8,
                               res_scale=0.01, round_res=True, bend=True),
                          k2._RES_I8_BF16),
                         (dict(act=None, q=0.7, residual=res_i8,
                               res_scale=0.01), k2._RES_I8),
                         (dict(act=None, residual=res_bf), k2._RES_BF16)):
            out_mode = k2._OUT_BF16 if kw.get("q") is None else k2._OUT_I8
            got = k2._launch(x, w, a, b, stride, kw["act"], kw.get("q"),
                             kw.get("residual"), kw.get("res_scale"), mode,
                             1, kw.get("bend", False), out_mode, tile)
            ref = int8_conv_reference(x, w, a, b, stride, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g_, r_ in zip(got, ref):
                assert torch.equal(g_, r_), (k, kw.keys(), (
                    g_.float() - r_.float()).abs().max())


def test_int8_conv_and_stem_instances_spill_nothing():
    """Every K2 instance (4 tiles x 16- or 4-byte copies) and every K3
    instance (7x7 and 3x3 x 16-byte or element window copies) holds its
    registers: at most 128 (two blocks of 256 threads an SM), no spills."""
    from pytorchcv_tpu_torch.kernels import int8_conv as k2
    from pytorchcv_tpu_torch.kernels import stem as k3
    _cuda()
    for bm, bn in k2.TILES:
        for vec in (True, False):
            info = k2.instance_info(bm, bn, vec)
            assert info["spill_bytes"] == 0 and info["registers"] <= 128, \
                (bm, bn, vec, info)
            assert info["dynamic_smem"] == k2.smem_bytes(bm, bn)
    for k, w in ((7, 224), (3, 480), (7, 46), (3, 46)):  # W % 8: 16 bytes
        info = k3.kernel_info(2, w, w, k)
        assert info["spill_bytes"] == 0 and info["registers"] <= 128, info
        assert info["dynamic_smem"] == k3.stem_smem(k, info["rows"], w)


@pytest.mark.parametrize("k,bsz,hw,cout", [(7, 2, 224, 64), (3, 2, 480, 64),
                                           (3, 2, 480, 32)])
def test_stem_kernel_matches_plain_at_path_shapes(k, bsz, hw, cout):
    """K3 at the ResNet stem (224 -> 112, Cout 64) and at DANet's 3x3
    (480 -> 240; its deep stem is 64 wide, and Cout 32): within the gate."""
    dev = _cuda()
    rng = np.random.default_rng(k * cout)
    x = torch.from_numpy(rng.standard_normal((bsz, 3, hw, hw)).astype(
        np.float32)).to(dev, torch.bfloat16)
    kf = torch.from_numpy((rng.standard_normal((3, k, k, cout)) * 0.1)
                          .astype(np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)
                            ).to(dev)
    got = stem_conv(x, kf, bias, 40.0)
    ref = stem_conv_reference(x, kf, bias, 40.0)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (bsz, hw // 2, hw // 2, cout)
    diff = (got.int() - ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("d,dv", [(32, 96), (64, 512), (16, 520),
                                  (128, 520), (20, 97)])
@pytest.mark.parametrize("lq", [63, 401, 3600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(lq, dtype, d, dv):
    """bf16 (the tensor-core instance) within 1 ulp (``bf16_ulp_error``:
    outputs that average to near zero round apart in f32); f32 (the CUDA
    core instance) within 1e-4 of the largest plain value. d 16 and 128
    pad to the instances' widths; dv 520 leaves a last chunk of 8; d 20
    and dv 97 (rows not a whole number of 16 bytes) load element by
    element."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(lq)
    q, k = (torch.randn((2, lq, d), generator=g).mul_(0.3).to(dev, dt)
            for _ in range(2))
    v = torch.randn((2, lq, dv), generator=g).to(dev, dt)
    got = flash_attention(q, k, v, 0.9)
    ref = flash_attention_reference(q, k, v, 0.9)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == ref.shape == (2, lq, dv)
    if dt == torch.bfloat16:
        assert float(bf16_ulp_error(got, ref).max()) <= 1, (d, dv)
    else:
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-4, (d, dv, err)


def _preprocess_case(case, rng):
    """(images, r, ct) of one K1 case: a small crop (also from a frame
    that starts 5 bytes past a 16-byte boundary), ResNet's 256 -> 224
    crop (batch 4), DANet's 1024x2048 -> 480x480 (batch 1), dense random
    matrices at DANet's shape, and ResNet's with an all-zero row of R and
    column of Ct."""
    hw, bsz = {"small": ((50, 70), 3), "offset": ((50, 70), 3),
               "resnet": ((256, 256), 4),
               "zero-row": ((256, 256), 4), "danet": ((1024, 2048), 1),
               "dense": ((1024, 2048), 1)}[case]
    if case in ("small", "offset"):
        r, c = resize_matrices(hw, 33)
    elif case in ("resnet", "zero-row"):
        r, c = resize_matrices(hw, 224)
    else:
        r, c = _pil_bilinear_matrix(hw[0], 480), _pil_bilinear_matrix(
            hw[1], 480)
    if case == "dense":
        r, c = (m / m.sum(1, keepdims=True) for m in (
            rng.random(r.shape, dtype=np.float32),
            rng.random(c.shape, dtype=np.float32)))
    r, c = r.copy(), c.copy()
    if case == "zero-row":
        r[5] = 0.0
        c[7] = 0.0
    imgs = rng.integers(0, 256, (bsz, *hw, 3), dtype=np.uint8)
    return imgs, r.astype(np.float32), np.ascontiguousarray(c.T, np.float32)


@pytest.mark.parametrize("case", ["small", "offset", "resnet", "danet",
                                  "dense", "zero-row"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_preprocess_kernel_matches_plain(layout, case):
    """f32 within 1e-4; bf16 within 1 ulp, per element on the small cases and
    with ``bf16_ulp_error``'s floor on the large ones (the affine cancels
    to near zero on some of their pixels, as on DANet's path). The dense
    case passes no band tables, so the wrapper makes them."""
    dev = _cuda()
    imgs, r, ct = (torch.from_numpy(x).to(dev) for x in _preprocess_case(
        case, np.random.default_rng(1)))
    if case == "offset":
        buf = torch.empty(imgs.numel() + 5, dtype=torch.uint8, device=dev)
        imgs = buf[5:].view(imgs.shape).copy_(imgs)
        assert imgs.data_ptr() % 16 == 5 and imgs.is_contiguous()
    a = torch.tensor([0.017, 0.018, 0.019], device=dev)
    b = torch.tensor([-2.1, -2.0, -1.8], device=dev)
    bands = None if case == "dense" else resize_bands(r, ct)
    for dtype in (torch.float32, torch.bfloat16):
        got = preprocess(imgs, r, ct, a, b, dtype, layout, bands=bands)
        ref = preprocess_reference(imgs, r, ct, a, b, dtype, layout)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        elif case in ("small", "offset"):
            assert int(bf16_ulp_distance(got, ref).max()) <= 1
        else:
            assert float(bf16_ulp_error(got, ref).max()) <= 1
        if case == "zero-row":
            # R's row 5 and Ct's column 7 have no taps: y = 0 * a + b
            want = b.to(dtype).view((1, 1, 3) if layout == "nhwc"
                                    else (1, 3, 1))
            for edge in ((got[:, 5], got[:, :, 7]) if layout == "nhwc"
                         else (got[:, :, 5], got[:, :, :, 7])):
                assert torch.equal(edge, want.expand_as(edge))


@pytest.mark.parametrize("k,shape", [(7, (2, 25, 23, 16)),
                                     (3, (2, 25, 23, 16))])
def test_stem_kernel_matches_plain(k, shape):
    dev = _cuda()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 3, 50, 46)).astype(
        np.float32)).to(dev, torch.bfloat16)
    kf = torch.from_numpy((rng.standard_normal((3, k, k, 16)) * 0.1).astype(
        np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32)
                            ).to(dev)
    got = stem_conv(x, kf, bias, 40.0)
    ref = stem_conv_reference(x, kf, bias, 40.0)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == shape
    diff = (got.int() - ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("hw", [(7, 9), (240, 240)])
def test_maxpool_i8_kernel_matches_plain(hw):
    dev = _cuda()
    x = _i8(np.random.default_rng(hw[0]), (2, *hw, 24), dev)
    got = maxpool_i8(x)
    ref = maxpool_i8_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(8, 112, 112, 64), (2, 240, 240, 128),
                                   (1, 7, 9, 24), (1, 13, 11, 3),
                                   (3, 9, 7, 64), (1, 2, 1, 16)])
def test_maxpool_i8_kernel_bit_exact_under_every_vector_and_run(shape):
    """``maxpool_i8`` at ResNet's (batch 8) and DANet's stem maps, at C 24
    and 3, odd H and W and batch 1: its plan, and every vector width that
    divides C under runs of 1, 2, 3 and 8 output rows."""
    from pytorchcv_tpu_torch.kernels.stem import _pool_launch
    dev = _cuda()
    x = _i8(np.random.default_rng(shape[1]), shape, dev)
    ref = maxpool_i8_reference(x)
    reset_launch_counts()
    assert torch.equal(maxpool_i8(x), ref) and LAUNCHES["maxpool_i8"] == 1
    for vb in (16, 8, 4, 1):
        if shape[3] % vb:
            continue
        for run in (1, 2, 3, 8):
            got = _pool_launch(x, torch.empty_like(ref), vb, run)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (vb, run)


def test_maxpool_i8_kernel_on_unaligned_views():
    """An input or output 8, 4 or 1 bytes off a 16-byte boundary narrows
    the vectors; the result stays bit-exact, and the -128 pad ties with
    -128 inputs."""
    from pytorchcv_tpu_torch.kernels.stem import maxpool_plan
    dev = _cuda()
    shape = (2, 11, 10, 64)
    x = _i8(np.random.default_rng(5), shape, dev)
    x[0, :3] = -128
    ref = maxpool_i8_reference(x)
    for off in (8, 4, 1):
        buf = torch.empty(x.numel() + off, dtype=torch.int8, device=dev)
        xv = buf[off:].view(shape)
        xv.copy_(x)
        assert maxpool_plan(*shape, off)[0] == off
        assert torch.equal(maxpool_i8(xv), ref), off
    torch.cuda.synchronize()


def test_maxpool_i8_instances_spill_nothing():
    from pytorchcv_tpu_torch.kernels.stem import maxpool_info
    _cuda()
    for vb in (16, 8, 4, 1):
        assert maxpool_info(vb)["spill_bytes"] == 0, vb


@pytest.mark.parametrize("name,kw,n_convs,n_chained", [
    ("resnet10", {}, 11, 0), ("resnet50", {"width_scale": 0.25}, 20, 11)])
def test_int8_pipeline_on_cuda_matches_cpu(name, kw, n_convs, n_chained):
    """Narrow and basic-block models end in a unit with an identity conv,
    the bf16-residual tail. The CUDA pipeline matches the CPU one on the
    same weights and scales; the narrow ResNet-50 runs its 11 stride-1
    units on K8 (C 64 / M 16 in stage 1)."""
    dev = _cuda()
    model = pt.get_model(name, in_size=(64, 64), device="cpu", **kw)
    raw = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 74, 74, 3), dtype=np.uint8))
    pre_cpu, pre_gpu = (classification_preprocess(
        name, (74, 74), layout="nchw", device=d) for d in ("cpu", dev))
    scales = calibrate_int8(model, [pre_cpu(raw).float()])
    infer, plan_cpu = prepare_int8_resnet(model, scales)
    _, plan_gpu = prepare_int8_resnet(copy.deepcopy(model).to(dev), scales)
    y_cpu = infer(plan_cpu, pre_cpu(raw)).float()
    reset_launch_counts()
    y_gpu = infer(plan_gpu, pre_gpu(raw.to(dev))).float().cpu()
    assert LAUNCHES == {"preprocess": 1, "stem": 1, "int8_conv": n_convs,
                        "maxpool_i8": 1, "flash_attention": 0,
                        "deform_sample": 0, "dwconv": 0,
                        "window_attention": 0,
                        "fused_bottleneck": n_chained, "stem_int8": 0,
                        "patch_window_sum": 0, "int8_gconv": 0,
                        "se_tail": 0, "dwconv_i8": 0}
    cos = float(torch.nn.functional.cosine_similarity(
        y_gpu.flatten(), y_cpu.flatten(), dim=0))
    assert cos >= 0.9999, cos


# ------------------------------------------- grouped K2, K11 (SE tails)

def _k2_modes(rng, shape, dev):
    """Every K2 epilogue: int8 and bf16 out with and without ReLU, and the
    unit tail with each residual mode, one with the bend."""
    res_i8 = _i8(rng, shape, dev)
    res_bf = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, torch.bfloat16)
    return [dict(act="relu", q=0.7), dict(act=None, q=0.7),
            dict(act="relu"), dict(act=None),
            dict(act=None, q=0.7, residual=res_i8, res_scale=0.01,
                 round_res=True, bend=True),
            dict(act=None, q=0.7, residual=res_i8, res_scale=0.01),
            dict(act=None, residual=res_bf)]


def _grouped_forced(x, w, a, b, stride, groups, tile, **kw):
    """The grouped kernel under block tile ``tile`` (the private launch the
    plans tool uses), with ``int8_conv``'s epilogue keywords."""
    from pytorchcv_tpu_torch.kernels import int8_conv as k2
    res = kw.get("residual")
    mode = (k2._RES_NONE if res is None else k2._RES_BF16
            if res.dtype == torch.bfloat16 else k2._RES_I8_BF16
            if kw.get("round_res") else k2._RES_I8)
    out_mode = k2._OUT_BF16 if kw.get("q") is None else k2._OUT_I8
    return k2._launch_grouped(x, w, a, b, stride, kw.get("act", "relu"),
                              kw.get("q"), res, kw.get("res_scale"), mode, 1,
                              kw.get("bend", False), groups, out_mode, tile)


@pytest.mark.parametrize("cg,og,groups,stride,hw,bsz", [
    (2, 2, 32, 1, (56, 56), 2), (2, 4, 32, 2, (28, 28), 2),
    (4, 4, 32, 1, (28, 28), 2), (4, 8, 32, 2, (14, 14), 3),
    (8, 8, 32, 2, (28, 28), 2), (8, 16, 32, 1, (14, 14), 2),
    (16, 16, 32, 1, (14, 14), 2), (16, 32, 32, 2, (14, 14), 2),
    (32, 32, 32, 1, (7, 7), 3), (32, 32, 64, 2, (14, 14), 1),
    (2, 6, 5, 1, (9, 13), 3), (16, 16, 5, 2, (11, 7), 3),
    (4, 2, 7, 1, (5, 6), 1), (32, 32, 3, 1, (9, 9), 5),
    (8, 8, 20, 1, (13, 150), 1)])
def test_grouped_int8_conv_kernel_matches_plain(cg, og, groups, stride, hw,
                                                bsz):
    """The grouped K2 at every per-group width of the ResNeXt, SE-ResNeXt
    and SENet paths (cg = og and og = 2 cg) and at ragged shapes (pixels no
    spatial tile divides, images wider than a tile, channel tiles the
    groups do not fill: Cout 96 and 160 under 128-channel blocks, og 6 and
    2), in every epilogue mode under the plan and under every tile of
    ``GCONV_TILES``: bit-exact against the plain version, counted under
    ``int8_gconv``."""
    from pytorchcv_tpu_torch.kernels import int8_conv as k2
    dev = _cuda()
    rng = np.random.default_rng(cg * 1000 + og * 10 + groups)
    cin, cout = cg * groups, og * groups
    x = _i8(rng, (bsz, *hw, cin), dev)
    w = _i8(rng, (cout, 3, 3, cg), dev)
    a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    ho, wo = ((n + 2 - 3) // stride + 1 for n in hw)
    for kw in _k2_modes(rng, (bsz, ho, wo, cout), dev):
        reset_launch_counts()
        got = int8_conv(x, w, a, b, stride, groups=groups, **kw)
        assert LAUNCHES["int8_gconv"] == 1 and LAUNCHES["int8_conv"] == 0
        ref = int8_conv_reference(x, w, a, b, stride, groups=groups, **kw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        runs = [("plan", got)] + [
            (tile, _grouped_forced(x, w, a, b, stride, groups, tile, **kw))
            for tile in k2.GCONV_TILES]
        torch.cuda.synchronize()
        for tile, out in runs:
            out = out if isinstance(out, tuple) else (out,)
            for g_, r_ in zip(out, ref):
                assert torch.equal(g_, r_), (tile, kw.keys(), (
                    g_.float() - r_.float()).abs().max())


def test_grouped_int8_conv_instances_spill_nothing():
    """Every grouped instance (the four block tiles x runs of 1, 2 and 4 n8
    tiles sharing A): no local memory, and the two blocks an SM the plan
    counts on at its shared memory of a ResNeXt-50 stage-1 conv."""
    from pytorchcv_tpu_torch.kernels import int8_conv as k2
    _cuda()
    for tile in k2.GCONV_TILES:
        plan = k2.gconv_tile(128, 56, 56, 128, 128, 32, 3, 1, 1, *tile)
        for u in (1, 2, 4):
            info = k2.gconv_info(plan._replace(u=u))
            assert info["spill_bytes"] == 0, (tile, u, info)
            assert info["blocks_per_sm"] >= plan.per_sm, (tile, u, info)


@pytest.mark.parametrize("c,out_i8", [(256, True), (2048, False),
                                      (36, True)])
def test_se_tail_kernel_matches_plain(c, out_i8):
    """K11 in every residual mode (int8 identity at the next scale, the
    unit's own int8 input rounded to bf16, a bf16 identity), int8 and bf16
    out, at C 36 (a thread an element) and on an unaligned view: bit-exact
    against the plain version handed the same gate."""
    from pytorchcv_tpu_torch.kernels.se_tail import (se_tail,
                                                     se_tail_reference)
    dev = _cuda()
    rng = np.random.default_rng(c)
    shape = (3, 7, 9, c)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3
                         ).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.uniform(0, 1, (3, c)).astype(np.float32)
                         ).to(dev)
    q = 0.9 if out_i8 else None
    res_i8 = _i8(rng, shape, dev)
    res_bf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                              ).to(dev, torch.bfloat16)
    cases = [dict(residual=res_i8, res_scale=0.02),
             dict(residual=res_i8, res_scale=0.02, round_res=True),
             dict(residual=res_bf)]
    for kw in cases:
        reset_launch_counts()
        got = se_tail(t, g, q=q, **kw)
        assert LAUNCHES["se_tail"] == 1
        ref = se_tail_reference(t, g, q=q, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), kw.keys()
    flat = torch.empty(t.numel() + 1, dtype=torch.bfloat16, device=dev)
    tv = flat[1:].view(shape)
    tv.copy_(t)
    assert torch.equal(se_tail(tv, g, q=q, **cases[0]),
                       se_tail_reference(t, g, q=q, **cases[0]))


@pytest.mark.parametrize("name", ["resnext14_32x2d", "seresnet10",
                                  "senet16"])
def test_se_group_pipeline_on_cuda_matches_cpu(name):
    """The grouped, SE and deep-stem routes on the card against the CPU on
    the same weights and scales: cosine >= 0.999, as the SE routes are
    held against the JAX package (the gate's f32 mean sums in another
    order on the card, and a gate one ulp apart moves a requantized value
    a step); launches K2 + grouped K2 + K11 as the plan counts them, no
    K8."""
    dev = _cuda()
    model = pt.get_model(name, in_size=(64, 64), device="cpu")
    g = torch.Generator().manual_seed(12)
    x = torch.randn((2, 3, 64, 64), generator=g)
    scales = calibrate_int8(model, [x])
    infer, plan_cpu = prepare_int8_resnet(model, scales)
    _, plan_gpu = prepare_int8_resnet(copy.deepcopy(model).to(dev), scales)
    y_cpu = infer(plan_cpu, x.to(torch.bfloat16)).float()
    reset_launch_counts()
    y_gpu = infer(plan_gpu, x.to(dev, torch.bfloat16)).float().cpu()
    steps = plan_cpu["stem_convs"] + [st for u in plan_cpu["units"] for st in
                                      (u["body"] + [u["last"]] +
                                       ([u["identity"]] if u["identity"]
                                        else []))]
    assert LAUNCHES["int8_gconv"] == sum(st["groups"] > 1 for st in steps)
    assert LAUNCHES["int8_conv"] == sum(st["groups"] == 1 for st in steps)
    assert LAUNCHES["se_tail"] == sum("se" in u for u in plan_cpu["units"])
    assert LAUNCHES["fused_bottleneck"] == 0
    cos = float(torch.nn.functional.cosine_similarity(
        y_gpu.flatten(), y_cpu.flatten(), dim=0))
    assert cos >= 0.999, cos


def _deform_inputs(rng, h, w, c, g, rb, dev, center_std=6.0):
    """x, offsets = center + U(-rb, rb) and mask, NCHW on ``dev``; centers
    of std 6 put windows across every border."""
    x = rng.standard_normal((1, c, h, w)).astype(np.float32)
    center = rng.normal(0.0, center_std, (1, 1, 1, 2, h, w))
    resid = rng.uniform(-rb, rb, (1, g, 9, 2, h, w))
    offset = (center + resid).astype(np.float32).reshape(1, 18 * g, h, w)
    mask = rng.random((1, 9 * g, h, w)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, offset, mask)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,c,g,rb", [
    (19, 27, 32, 4, 2.5), (14, 15, 48, 3, 5.0), (30, 54, 256, 16, 5.0),
    (60, 108, 128, 16, 3.0)])
def test_deform_sample_kernel_matches_plain(h, w, c, g, rb, dtype):
    """W not a multiple of 8, H*W*9*C not a multiple of the 256-thread
    block (the first two shapes), RFC's and the flow-guided shape."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    x, offset, mask = _deform_inputs(np.random.default_rng(h * w), h, w, c,
                                     g, rb, dev)
    x = x.to(dt)
    reset_launch_counts()
    got = deform_sample(x, offset, mask, g, rb)
    assert LAUNCHES["deform_sample"] == 1
    ref = deform_sample_reference(x, offset, mask, g)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (h * w, 9, c) and got.dtype == dt
    if dt == torch.bfloat16:
        assert float(bf16_ulp_error(got, ref).max()) <= 1
    else:
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(x.abs().max()), err


def test_deform_conv2d_routes_agree_on_cuda():
    """The contract route (K5, one launch) and the general route (no
    center) give the same deformable conv."""
    dev = _cuda()
    x, offset, mask = _deform_inputs(np.random.default_rng(7), 30, 54, 64,
                                     16, 5.0, dev)
    wgt = torch.randn(32, 64, 3, 3, device=dev) * 0.05
    bias = torch.randn(32, device=dev)
    center = torch.zeros(1, 2, 30, 54, device=dev)
    reset_launch_counts()
    got = deform_conv2d(x, offset, mask, wgt, bias, deform_groups=16,
                        center=center, residue_bound=5.0)
    assert LAUNCHES["deform_sample"] == 1
    ref = deform_conv2d(x, offset, mask, wgt, bias, deform_groups=16)
    torch.cuda.synchronize()
    assert LAUNCHES["deform_sample"] == 1
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


def test_deform_sample_refuses_calls_outside_the_contract():
    dev = _cuda()
    x, offset, mask = _deform_inputs(np.random.default_rng(8), 12, 16, 32,
                                     4, 2.0, dev)
    with pytest.raises(ValueError, match="P = 14"):      # H < P at rb 5
        deform_sample(x, offset, mask, 4, 5.0)
    with pytest.raises(ValueError, match=r"\(1, C, H, W\)"):  # batch 2
        deform_sample(torch.cat([x, x]), offset, mask, 4, 2.0)
    with pytest.raises(ValueError, match="do not match"):
        deform_sample(x, offset[:, :36], mask, 4, 2.0)
    with pytest.raises(ValueError, match="C % G"):
        deform_sample(x, offset, mask, 5, 2.0)
    with pytest.raises(ValueError, match="several devices"):
        deform_sample(x, offset.cpu(), mask, 4, 2.0)


def _check_sampled(got, x, offset, mask, g):
    ref = deform_sample_reference(x, offset, mask, g)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == x.dtype
    if x.dtype == torch.bfloat16:
        assert float(bf16_ulp_error(got, ref).max()) <= 1
    else:
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(x.abs().max()), err


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,c,g,rb", [
    (30, 54, 256, 16, 5.0), (60, 108, 128, 16, 3.0), (14, 15, 36, 4, 5.0),
    (19, 27, 48, 4, 2.5), (8, 9, 1200, 300, 2.0)])
def test_deform_sample_kernel_both_layouts(h, w, c, g, rb, dtype, layout):
    """K5 on x as it lies: NCHW (the launch transposes it) and
    channels-last (read directly), at RFC's and the generator's shapes, at
    C/G 9 (one channel a vector) and 12 (8-byte bf16 vectors), and with 300
    groups (more samples a pixel than a tile stages)."""
    dev = _cuda()
    x, offset, mask = _deform_inputs(np.random.default_rng(h * w + c), h, w,
                                     c, g, rb, dev)
    x = x.to(getattr(torch, dtype))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    reset_launch_counts()
    got = deform_sample(x, offset, mask, g, rb)
    assert LAUNCHES["deform_sample"] == 1
    _check_sampled(got, x, offset, mask, g)


def test_deform_sample_kernel_on_an_unaligned_view():
    """A channels-last x that starts 4 bytes past an aligned address takes
    one-channel vectors."""
    dev = _cuda()
    x, offset, mask = _deform_inputs(np.random.default_rng(11), 16, 20, 64,
                                     4, 2.0, dev)
    buf = torch.empty(x.numel() + 1, device=dev)
    xv = buf[1:].view(1, 16, 20, 64)
    xv.copy_(x.permute(0, 2, 3, 1))
    xv = xv.permute(0, 3, 1, 2)
    assert xv.data_ptr() % 16 == 4
    reset_launch_counts()
    got = deform_sample(xv, offset, mask, 4, 2.0)
    assert LAUNCHES["deform_sample"] == 1
    _check_sampled(got, xv, offset, mask, 4)


def test_deform_sample_instances_spill_nothing():
    from pytorchcv_tpu_torch.kernels import deform_patch as k5
    _cuda()
    for dtype in (torch.float32, torch.bfloat16):
        for cg in (16, 4, 2, 1):
            for nhwc in (True, False):
                info = k5.kernel_info(16 * cg, 16, dtype, nhwc)
                assert info["spill_bytes"] == 0, (dtype, cg, nhwc, info)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad,shape", [
    (3, 1, ((1, 1), (1, 1)), (3, 5, 13, 11)),
    (3, 2, ((0, 1), (0, 1)), (2, 7, 28, 30)),
    (5, 2, ((1, 2), (2, 1)), (2, 9, 15, 17)),
    (5, 1, ((2, 2), (2, 2)), (1, 3, 130, 3)),
    (7, 2, ((3, 3), (3, 3)), (2, 4, 23, 19)),
    (7, 1, ((0, 0), (0, 0)), (1, 6, 9, 40))])
def test_dwconv_kernel_matches_plain(k, stride, pad, shape, dtype):
    """Odd sizes, asymmetric pads, no pad, output planes of 1 to 390
    pixels (no multiple of the 128-pixel block), every activation: f32
    bit-exact for the piecewise-linear ones and within 1e-6 of max |plain|
    for sigmoid and swish, bf16 within 1 bf16 ulp."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(k * 100 + shape[2])
    n, c, h, w = shape
    x = (torch.randn(shape, generator=g) * 2).to(dev, dt)
    wgt = (torch.randn((c, 1, k, k), generator=g) * 0.3).to(dev, dt)
    scale = torch.empty(c).uniform_(0.5, 1.5, generator=g).to(dev)
    shift = (torch.randn(c, generator=g) * 0.3).to(dev)
    for act in ACTIVATIONS:
        reset_launch_counts()
        got = dwconv2d_bn_act(x, wgt, scale, shift, stride, pad, act)
        assert LAUNCHES["dwconv"] == 1
        ref = dwconv2d_bn_act_reference(x, wgt, scale, shift, stride, pad,
                                        act)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dt
        if dt == torch.bfloat16:
            assert float(bf16_ulp_error(got, ref).max()) <= 1, act
        elif act in ("sigmoid", "swish"):
            err = float((got - ref).abs().max() / ref.abs().max())
            assert err <= 1e-6, (act, err)
        else:
            assert torch.equal(got, ref), act


def test_dwconv_refuses_calls_outside_the_contract():
    dev = _cuda()
    x = torch.randn(2, 8, 9, 9, device=dev)
    w = torch.randn(8, 1, 3, 3, device=dev)
    s, b = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    pad = ((1, 1), (1, 1))
    with pytest.raises(ValueError, match="several devices"):
        dwconv2d_bn_act(x, w, s.cpu(), b, 1, pad, "relu")
    with pytest.raises(ValueError, match="not contiguous"):
        dwconv2d_bn_act(x.transpose(2, 3), w, s, b, 1, pad, "relu")
    with pytest.raises(ValueError, match="w must be"):
        dwconv2d_bn_act(x.to(torch.bfloat16), w, s, b, 1, pad, "relu")
    with pytest.raises(ValueError, match="stride"):
        dwconv2d_bn_act(x, w, s, b, 3, pad, "relu")
    with pytest.raises(ValueError, match="no backward"):
        dwconv2d_bn_act(x, w.clone().requires_grad_(True), s, b, 1, pad,
                        "relu")


def _dw_calls(name, dev, monkeypatch, bsz=2):
    """(x shape, k, stride, pad) of each depthwise call of a 224x224 bf16
    forward of ``name``, in order."""
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    seen = []
    orig = conv_mod.dwconv2d_bn_act

    def rec(x, w, scale, shift, stride, pad, act):
        seen.append((tuple(x.shape), w.shape[-1], stride, pad))
        return orig(x, w, scale, shift, stride, pad, act)
    monkeypatch.setattr(conv_mod, "dwconv2d_bn_act", rec)
    model = as_bfloat16(pt.get_model(name, device="cpu")).to(dev)
    with torch.inference_mode():
        model(torch.zeros((bsz, 3, 224, 224), dtype=torch.bfloat16,
                          device=dev))
    monkeypatch.undo()
    return seen


def _dw_operands(shape, k, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    return ((torch.randn(shape, generator=g) * 2).to(dev, dtype),
            (torch.randn((c, 1, k, k), generator=g) * 0.3).to(dev, dtype),
            torch.empty(c).uniform_(0.5, 1.5, generator=g).to(dev),
            (torch.randn(c, generator=g) * 0.3).to(dev))


def _assert_dw_close(got, ref, act, what=None):
    """f32 bit-exact for the piecewise-linear activations, within 1e-6 of
    max |plain| for sigmoid and swish; bf16 within 1 bf16 ulp."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == torch.bfloat16:
        assert float(bf16_ulp_error(got, ref).max()) <= 1, (act, what)
    elif act in ("sigmoid", "swish"):
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-6, (act, err, what)
    else:
        assert torch.equal(got, ref), (act, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["efficientnet_b0", "efficientnet_b0b"])
def test_dwconv_kernel_at_every_efficientnet_call(name, dtype, monkeypatch):
    """K6 under its plans at each depthwise call of a 224x224 forward (the
    16 of B0; B0b's TF-SAME pads, asymmetric at stride 2), every
    activation, one launch a call."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    calls = _dw_calls(name, dev, monkeypatch)
    assert len(calls) == 16
    for i, (shape, k, stride, pad) in enumerate(calls):
        x, w, scale, shift = _dw_operands(shape, k, dt, dev, i)
        for act in ACTIVATIONS:
            reset_launch_counts()
            got = dwconv2d_bn_act(x, w, scale, shift, stride, pad, act)
            assert LAUNCHES["dwconv"] == 1
            ref = dwconv2d_bn_act_reference(x, w, scale, shift, stride, pad,
                                            act)
            torch.cuda.synchronize()
            _assert_dw_close(got, ref, act, (shape, k, stride, pad))


@pytest.mark.parametrize("k,stride,pad,shape,plans", [
    (3, 1, ((1, 1), (1, 1)), (2, 5, 13, 11),
     [(4, 1, 5, 32), (7, 1, 13, 64), (7, 3, 13, 64), (4, 4, 13, 256)]),
    (5, 2, ((1, 2), (2, 1)), (2, 9, 15, 17),
     [(4, 1, 3, 32), (7, 2, 7, 64), (4, 5, 7, 96), (4, 1, 1, 32)]),
    (7, 2, ((3, 3), (3, 3)), (1, 6, 23, 19),
     [(7, 1, 5, 32), (7, 6, 12, 256), (4, 1, 11, 128)]),
    (3, 2, ((0, 1), (0, 1)), (2, 3, 112, 112),
     [(4, 1, 8, 64), (7, 1, 56, 256), (4, 1, 3, 32)]),
])
def test_dwconv_kernel_under_forced_plans(k, stride, pad, shape, plans):
    """K6 bit-exact (f32, relu) and within 1 bf16 ulp under plans the
    plan would not pick: strips of 4 and 7, ragged last tiles of whole
    planes, ragged last bands, several strips a thread."""
    from pytorchcv_tpu_torch.kernels.dwconv import DwPlan, _launch
    dev = _cuda()
    for dt in (torch.float32, torch.bfloat16):
        x, w, scale, shift = _dw_operands(shape, k, dt, dev, k)
        ref = dwconv2d_bn_act_reference(x, w, scale, shift, stride, pad,
                                        "relu")
        for plan in plans:
            got = _launch(x, w, scale, shift, stride, pad, "relu",
                          DwPlan(*plan))
            torch.cuda.synchronize()
            _assert_dw_close(got, ref, "relu", (plan, dt))


def test_dwconv_kernel_on_an_unaligned_view():
    """x and the output span starting off a 16-byte boundary: the kernel
    reads aligned vectors around the span and writes the ends apart."""
    dev = _cuda()
    for dt in (torch.float32, torch.bfloat16):
        x, w, scale, shift = _dw_operands((2, 7, 9, 11), 3, dt, dev, 3)
        buf = torch.empty(x.numel() + 3, dtype=dt, device=dev)
        xv = buf[3:].view(x.shape)
        xv.copy_(x)
        assert xv.is_contiguous() and xv.data_ptr() % 16
        for stride in (1, 2):
            got = dwconv2d_bn_act(xv, w, scale, shift, stride,
                                  ((1, 1), (1, 1)), "hswish")
            ref = dwconv2d_bn_act_reference(x, w, scale, shift, stride,
                                            ((1, 1), (1, 1)), "hswish")
            torch.cuda.synchronize()
            _assert_dw_close(got, ref, "hswish", (dt, stride))


def test_dwconv_instances_spill_nothing():
    """Every K6 instance (k 3/5/7, stride 1/2, strips of 4 and 7, f32 and
    bf16) keeps its registers: no local memory; the kernel's layout of a
    tile takes the shared bytes ``tile_geometry`` gives."""
    import ctypes
    from pytorchcv_tpu_torch.kernels._build import library
    from pytorchcv_tpu_torch.kernels.dwconv import tile_geometry
    _cuda()
    out = (ctypes.c_int * 4)()
    for k in (3, 5, 7):
        for stride in (1, 2):
            for v in (4, 7):
                for bf16 in (0, 1):
                    ho = (28 + 2 * (k // 2) - k) // stride + 1
                    g = tile_geometry(28, 28, ho, ho, k, stride, v, 3, ho,
                                      2 if bf16 else 4)
                    assert library().pcv_dwconv_info(
                        k, stride, v, bf16, 28, 28, ho, ho, 3, ho,
                        g.row_pitch, g.half, g.plane_pitch, out) == 0
                    assert out[1] == 0, (k, stride, v, bf16, list(out))
                    assert out[3] == g.smem, (k, stride, v, bf16, list(out))


def test_efficientnet_f32_under_autocast_on_cuda():
    """An f32 EfficientNet-B0 eval forward under bf16 autocast launches K6
    in its 16 depthwise blocks and agrees with its unfused route under the
    same autocast; under f16 autocast K6 stays out."""
    from pytorchcv_tpu_torch.nn import unfused_depthwise
    dev = _cuda()
    model = pt.get_model("efficientnet_b0", device="cpu").to(dev).eval()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 3, 224, 224), generator=g).to(dev)
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        reset_launch_counts()
        y = model(x).float()
        assert LAUNCHES["dwconv"] == 16
        with unfused_depthwise(model):
            y_ref = model(x).float()
    with torch.inference_mode(), torch.autocast("cuda", torch.float16):
        reset_launch_counts()
        model(x)
        assert LAUNCHES["dwconv"] == 0
    cos = float(torch.nn.functional.cosine_similarity(
        y.flatten(), y_ref.flatten(), dim=0))
    assert cos >= 0.999, cos


@pytest.mark.parametrize("name", ["efficientnet_b0", "efficientnet_b0b"])
def test_efficientnet_bf16_on_cuda_matches_cpu(name):
    """The bf16 model on the card (K6 in its 16 depthwise blocks, cuDNN
    elsewhere) against the same model on the CPU (the plain version)."""
    dev = _cuda()
    model = pt.get_model(name, in_size=(64, 64), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    bf = as_bfloat16(model)
    x = torch.randn((4, 3, 64, 64), generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        y_cpu = bf(x).float()
        bf_gpu = copy.deepcopy(bf).to(dev)
        reset_launch_counts()
        y_gpu = bf_gpu(x.to(dev)).float().cpu()
    assert LAUNCHES["dwconv"] == 16
    cos = float(torch.nn.functional.cosine_similarity(
        y_gpu.flatten(), y_cpu.flatten(), dim=0))
    assert cos >= 0.999, cos


@pytest.mark.parametrize("lead,d,lq,lk,masked,dtype", [
    ((3, 2), d, lq, lk, masked, dtype)
    for d in (16, 32, 64, 128)
    for lq, lk, masked in ((1, 1, False), (1, 300, True), (45, 45, False),
                           (70, 129, True), (200, 63, False))
    for dtype in ("float32", "bfloat16")] + [
    ((4, 1), 128, 810, 2142, True, "float32")])    # the generator's full path
def test_window_attention_kernel_matches_plain(lead, d, lq, lk, masked,
                                               dtype):
    """Lq = 1, Lk no tile divides, masks of 0 and -1e9 broadcast over the
    heads, and the generator's full-path shape: f32 within 2e-5 of the
    largest plain value, bf16 within 1 ulp; the instance spills
    nothing."""
    from pytorchcv_tpu_torch.kernels.attention import kernel_info
    dev = _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(d * 1000 + lq + lk)
    q = torch.randn((*lead, lq, d), generator=g).to(dev, dt)
    k, v = (torch.randn((*lead, lk, d), generator=g).to(dev, dt)
            for _ in range(2))
    mask = None
    if masked:
        mask = torch.where(torch.rand((lead[0], 1, lq, lk), generator=g)
                           > 0.4, 0.0, -1e9).to(dev)
    reset_launch_counts()
    got = fused_window_attention(q, k, v, 0.7, mask)
    ref = fused_window_attention_reference(
        q, k, v, 0.7, None if mask is None else mask.expand(*lead, lq, lk))
    torch.cuda.synchronize()
    assert LAUNCHES["window_attention"] == 1
    assert kernel_info(d, dt, lq)["spill_bytes"] == 0
    assert got.dtype == dt and got.shape == (*lead, lq, d)
    if dt == torch.bfloat16:
        assert float(bf16_ulp_error(got, ref).max()) <= 1
    else:
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 2e-5, err


def test_window_attention_refuses_calls_outside_the_contract():
    dev = _cuda()
    q = torch.zeros((2, 4, 16), device=dev)
    wide = torch.zeros((2, 4, 129), device=dev)
    with pytest.raises(ValueError, match="D <= 128"):
        fused_window_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="several devices"):
        fused_window_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="no backward"):
        fused_window_attention(q.clone().requires_grad_(True), q, q)


def _narrow_propainter():
    """ProPainter at hidden 128, depth 2 on the CPU. As in the CPU parity
    test, the last conv of each ``conv_offset`` and the last decoder conv
    are scaled down by 100: at the init's scale the propagation's
    recurrence amplifies rounding chaotically."""
    model = pt.get_model("propainter", hidden_dim=128, depth=2,
                         device="cpu")
    with torch.no_grad():
        for align in model.feat_prop_module.deform_align.values():
            align.conv_offset.conv4.conv.weight.mul_(0.01)
        model.decoder.unit2.conv2.conv.weight.mul_(0.01)
    return model


def _smooth_clip(t, g):
    """Frames in [-1, 1], ~10 % masked pixels, smooth flows of 3 px
    (T-1, 4, 96, 176)."""
    frames = torch.rand((t, 3, 96, 176), generator=g) * 2 - 1
    masks = (torch.rand((t, 1, 96, 176), generator=g) > 0.9).float()
    ys = torch.linspace(0, 6.2832, 96)[:, None]
    xs = torch.linspace(0, 6.2832, 176)[None, :]
    phase = torch.rand((t - 1, 4, 1, 1), generator=g) * 6.2832
    return frames, masks, 3 * torch.sin(ys + 2 * xs + phase)


def test_propainter_on_cuda_matches_cpu():
    """The narrow generator at 96x176 on the card (K7 on both attention
    paths of each block, K5 in the feature propagation) against the same
    model on the CPU (the plain versions), f32 with TF32 off."""
    dev = _cuda()
    model = _narrow_propainter()
    g = torch.Generator().manual_seed(3)
    t, l_t = 7, 5
    frames, masks, flows = _smooth_clip(t, g)
    args = (frames[None], masks[None], masks[None], flows[None, :l_t - 1],
            l_t)
    with torch.inference_mode(), no_tf32():
        y_cpu = model(*args)
        gpu = copy.deepcopy(model).to(dev)
        reset_launch_counts()
        y_gpu = gpu(*(a.to(dev) if torch.is_tensor(a) else a
                      for a in args)).cpu()
    assert LAUNCHES["window_attention"] == 4
    assert LAUNCHES["deform_sample"] == 2 * (l_t - 1)
    err = float((y_gpu - y_cpu).abs().max() / y_cpu.abs().max())
    assert err <= 1e-4, err


def test_propainter_sequencers_on_cuda_match_cpu():
    """IP -> IT -> IM over 12 frames: image propagation on its default
    device (the card) and the narrow generator on the card, against the
    same chain on the CPU."""
    dev = _cuda()
    from pytorchcv_tpu_torch.models.propainter_stream import (
        ProPainterIMSequencer, ProPainterIPSequencer, ProPainterITSequencer)
    from pytorchcv_tpu_torch.streaming import TensorSequencer
    model = _narrow_propainter()
    frames, masks, flows = _smooth_clip(12, torch.Generator().manual_seed(4))

    def chain(m, f, k, fl, device):
        comp = TensorSequencer(fl)
        return ProPainterIMSequencer(ProPainterITSequencer(
            ProPainterIPSequencer(f, k, comp, device=device), k, comp,
            pp_model=m), f, k)[0:len(f)]
    y_cpu = chain(model, frames, masks, flows, "cpu")
    reset_launch_counts()
    y_gpu = chain(copy.deepcopy(model).to(dev), frames.to(dev),
                  masks.to(dev), flows.to(dev), None).cpu()
    assert LAUNCHES["window_attention"] == 3 * 4
    assert LAUNCHES["deform_sample"] == 2 * (5 + 10 + 6)
    err = float((y_gpu - y_cpu).abs().max() / y_cpu.abs().max())
    assert err <= 1e-4, err


def _chain_inputs(rng, bsz, h, w, c, m, n_units, dev):
    """K8's packed operands for ``n_units`` random units (int8 weights,
    gains around 1/(127 sqrt(K)) so the int8 chain stays spread) and x."""
    from pytorchcv_tpu_torch.kernels.fused_bottleneck import pack_units

    def cell(cout, k, cin):
        return {"wq": _i8(rng, (cout, k, k, cin), dev),
                "gain": torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (
                    127.0 * np.sqrt(k * k * cin))).astype(np.float32)).to(dev),
                "bias": torch.from_numpy((rng.standard_normal(cout) * 0.1)
                                         .astype(np.float32)).to(dev)}
    units = [{"conv1": cell(m, 1, c), "conv2": cell(m, 3, m),
              "conv3": cell(c, 1, m)} for _ in range(n_units)]
    s_chain = list(rng.uniform(1.0, 3.0, 3 * n_units + 1))
    return _i8(rng, (bsz, h, w, c), dev), pack_units(units, s_chain)


@pytest.mark.parametrize("bsz,h,w,c,m,n_units", [
    (2, 7, 5, 64, 16, 3),          # odd map, narrow widths
    (3, 30, 20, 256, 128, 2),      # several row tiles, a ragged last one
    (2, 7, 7, 2048, 1024, 1),      # WRN-50-2's stage 4 (t1 81 KB, t2 49 KB)
    (1, 56, 56, 256, 64, 2),       # ResNet-50's stage 1
    (3, 14, 14, 1024, 256, 2),     # ResNet-50's stage 3
    (3, 7, 7, 2048, 512, 1),       # ResNet-50's stage 4, an odd batch
    (2, 4, 53, 256, 1024, 1),      # the widest row at M 1024: column tiles
    (1, 3, 108, 128, 512, 1)])     # the widest row at M 512: column tiles
def test_fused_bottleneck_kernel_matches_plain(bsz, h, w, c, m, n_units):
    """Bit-exact against the plain version; the kernel spills nothing."""
    from pytorchcv_tpu_torch.kernels.fused_bottleneck import (
        fused_bottleneck_chain, fused_bottleneck_chain_reference,
        kernel_info)
    dev = _cuda()
    assert kernel_info(bsz, h, w, c, m)["spill_bytes"] == 0
    x, packed = _chain_inputs(np.random.default_rng(h * w + m), bsz, h, w,
                              c, m, n_units, dev)
    reset_launch_counts()
    got = fused_bottleneck_chain(x, packed)
    assert LAUNCHES["fused_bottleneck"] == n_units
    ref = fused_bottleneck_chain_reference(x, packed)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert float((ref != 0).float().mean()) > 0.2


def test_int8_stem_kernel_matches_plain():
    """K9 at an image no 32-pixel tile divides and 32 output channels."""
    from pytorchcv_tpu_torch.kernels.stem_conv import (
        stem_conv7x7_s2, stem_conv7x7_s2_reference)
    dev = _cuda()
    g = torch.Generator().manual_seed(9)
    x = (torch.randn((3, 70, 46, 3), generator=g) * 1.5).to(dev)
    k7 = (torch.randn((7, 7, 3, 32), generator=g) * 0.1).to(dev)
    gain = (torch.rand(32, generator=g) + 0.5).to(dev)
    bias = (torch.randn(32, generator=g) * 0.1).to(dev)
    reset_launch_counts()
    got = stem_conv7x7_s2(x, k7, gain, bias, 3.0, 2.0)
    assert LAUNCHES["stem_int8"] == 1
    ref = stem_conv7x7_s2_reference(x, k7, gain, bias, 3.0, 2.0)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (3, 35, 23, 32) and torch.equal(got, ref)


@pytest.mark.parametrize("bsz,hw,cout", [(3, 224, 64), (2, 224, 8),
                                         (2, 70, 40)])
def test_int8_stem_kernel_bit_exact_at_the_stem_shape(bsz, hw, cout):
    """K9 at 224 -> 112 with O 64 (batch 3), and at O 8 and 40 (8-byte
    output stores), through its plan's rows."""
    from pytorchcv_tpu_torch.kernels.stem_conv import (
        stem_conv7x7_s2, stem_conv7x7_s2_reference)
    dev = _cuda()
    g = torch.Generator().manual_seed(cout)
    x = (torch.randn((bsz, hw, hw, 3), generator=g) * 1.5).to(dev)
    k7 = (torch.randn((7, 7, 3, cout), generator=g) * 0.1).to(dev)
    gain = (torch.rand(cout, generator=g) + 0.5).to(dev)
    bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
    reset_launch_counts()
    got = stem_conv7x7_s2(x, k7, gain, bias, 3.0, 2.0)
    assert LAUNCHES["stem_int8"] == 1
    ref = stem_conv7x7_s2_reference(x, k7, gain, bias, 3.0, 2.0)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (bsz, hw // 2, hw // 2, cout)
    assert torch.equal(got, ref)
    assert float((ref > 0).float().mean()) > 0.2


def test_int8_stem_kernel_follows_writes_through_data():
    """K9 quantizes the weights it is given on every call: after writes
    through ``.data`` (which bump no version counter) it gives the plain
    result of the new weights; the prepared entry is bit-equal."""
    from pytorchcv_tpu_torch.kernels.stem_conv import (
        prepare_stem, stem_conv7x7_s2, stem_conv7x7_s2_prepared,
        stem_conv7x7_s2_reference)
    dev = _cuda()
    g = torch.Generator().manual_seed(11)
    x = (torch.randn((2, 32, 32, 3), generator=g) * 1.5).to(dev)
    k7 = (torch.randn((7, 7, 3, 16), generator=g) * 0.1).to(dev)
    gain = (torch.rand(16, generator=g) + 0.5).to(dev)
    bias = (torch.randn(16, generator=g) * 0.1).to(dev)
    first = stem_conv7x7_s2(x, k7, gain, bias, 3.0, 2.0)
    for write in (lambda: k7.data.mul_(2.0),
                  lambda: k7.data.__setitem__((0, 0, 0, 0), 100.0)):
        write()
        got = stem_conv7x7_s2(x, k7, gain, bias, 3.0, 2.0)
        ref = stem_conv7x7_s2_reference(x, k7, gain, bias, 3.0, 2.0)
        _, wq, gq = prepare_stem(k7, gain, bias, 3.0, 2.0)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and not torch.equal(got, first)
        assert torch.equal(stem_conv7x7_s2_prepared(x, wq, gq, bias, 3.0,
                                                    2.0), got)


def test_int8_stem_kernel_spills_nothing():
    from pytorchcv_tpu_torch.kernels import stem_conv as k9
    _cuda()
    for b, h, w in ((128, 224, 224), (3, 70, 46)):
        info = k9.kernel_info(b, h, w)
        assert info["spill_bytes"] == 0 and info["registers"] <= 128, info
        assert info["dynamic_smem"] == k9.stem_int8_smem(info["rows"], w // 2)


def test_patch_window_sum_kernel_matches_plain():
    """K10 at an n no tile of 80 divides, 96 channels, starts outside the
    map (clamped by both); 333 starts on 217 distinct windows: the table
    and the gather, two launches."""
    from pytorchcv_tpu_torch.kernels.patch_probe import (
        patch_window_sum, patch_window_sum_reference)
    dev = _cuda()
    g = torch.Generator().manual_seed(10)
    x = torch.randn((40, 70, 96), generator=g).to(dev, torch.bfloat16)
    starts = torch.stack([torch.randint(-15, 55, (333,), generator=g),
                          torch.randint(-20, 90, (333,), generator=g)], 1)
    starts = starts.to(dev, torch.int32)
    reset_launch_counts()
    got = patch_window_sum(x, starts)
    assert LAUNCHES["patch_window_sum"] == 2
    ref = patch_window_sum_reference(x, starts)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


@pytest.mark.parametrize("h,w,c,n,launches", [
    (60, 128, 128, 6480, 2), (60, 128, 128, 500, 1), (23, 61, 40, 900, 2),
    (12, 30, 20, 5, 1), (14, 33, 20, 200, 2)])
def test_patch_window_sum_bit_equal_to_fixed_order(h, w, c, n, launches):
    """K10 bit-equal to the fixed-order sum (rows outer, columns inner, f32
    adds on the card): at the probe tool's shapes (6480 starts on 714
    windows: table and gather), at n below the distinct windows (one
    direct launch), and at C no 16-byte vector divides."""
    from pytorchcv_tpu_torch.kernels.patch_probe import (
        clamped_starts, patch_window_sum)
    dev = _cuda()
    g = torch.Generator().manual_seed(h * n)
    x = torch.randn((h, w, c), generator=g).to(dev, torch.bfloat16)
    starts = torch.stack([torch.randint(-3, h, (n,), generator=g),
                          torch.randint(-9, w + 9, (n,), generator=g)],
                         1).to(dev, torch.int32)
    reset_launch_counts()
    got = patch_window_sum(x, starts)
    assert LAUNCHES["patch_window_sum"] == launches
    sy, sx = clamped_starts(starts, h, w).unbind(1)
    want = torch.zeros_like(got)
    for r in range(10):
        for q in range(24):
            want = want + x.float()[sy + r, sx + q]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_resnet50_logits_with_and_without_chains_on_cuda():
    """The chained plan (K8 on the 11 stride-1 units) and the K2-only plan
    give the same logits bit for bit."""
    dev = _cuda()
    model = pt.get_model("resnet50", in_size=(64, 64), device=dev)
    g = torch.Generator().manual_seed(11)
    x = torch.randn((4, 3, 64, 64), generator=g).to(dev)
    with no_tf32():
        scales = calibrate_int8(model, [x])
    infer, plan = prepare_int8_resnet(model, scales)
    infer_k2, plan_k2 = prepare_int8_resnet(model, scales, chains=False)
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        reset_launch_counts()
        got = infer(plan, xb)
        assert (LAUNCHES["fused_bottleneck"], LAUNCHES["int8_conv"]) == \
            (11, 19)
        reset_launch_counts()
        ref = infer_k2(plan_k2, xb)
        assert (LAUNCHES["fused_bottleneck"], LAUNCHES["int8_conv"]) == \
            (0, 52)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_danet_position_attention_gradients_match_cpu():
    """PosAttBlock with grad on takes the plain attention on the card as on
    the CPU (K4 has no backward): the conv gradients agree."""
    from pytorchcv_tpu_torch.models.danet import PosAttBlock
    dev = _cuda()
    torch.manual_seed(12)
    block = PosAttBlock(64)
    with torch.no_grad():
        block.scale.alpha.fill_(0.8)
    x = torch.randn(2, 64, 12, 15)
    grads = []
    for d in ("cpu", dev):
        b = copy.deepcopy(block).to(d)
        reset_launch_counts()
        with no_tf32():
            b(x.to(d)).square().sum().backward()
        assert LAUNCHES["flash_attention"] == 0
        grads.append([m.weight.grad.cpu() for m in
                      (b.query_conv, b.key_conv, b.value_conv)])
    for g_cpu, g_gpu in zip(*grads):
        err = float((g_gpu - g_cpu).abs().max() / g_cpu.abs().max())
        assert err <= 1e-4, err


def test_direct_forward_computes_f32_under_tf32_defaults():
    """get_model's models pin f32: with torch's TF32 flags on, a direct
    resnet50 forward equals the same forward under ``no_tf32()``."""
    dev = _cuda()
    model = pt.get_model("resnet50", in_size=(96, 96), device=dev)
    x = torch.randn((2, 3, 96, 96), generator=torch.Generator().manual_seed(
        13)).to(dev)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with torch.inference_mode():
            y_default = model(x)
            with no_tf32():
                y_f32 = model(x)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(y_default, y_f32)


def _moving_frames(t, h, w, g):
    """(t, 3, H, W) frames in [-1, 1]: a smooth random texture shifted by
    ~3 px from frame to frame."""
    ys = torch.arange(h, dtype=torch.float32)[:, None]
    xs = torch.arange(w, dtype=torch.float32)[None, :]
    out = torch.zeros(t, 3, h, w)
    for _ in range(6):
        fy, fx = (torch.rand(2, generator=g) * 0.15 + 0.02).tolist()
        ph = torch.rand(3, 1, 1, generator=g) * 6.2832
        for i in range(t):
            out[i] += torch.sin(fy * (ys + 1.5 * i) + fx * (xs + 2.5 * i)
                                + ph) / 3
    return out.clamp(-1.0, 1.0)


def _tamed_raft(name, **kw):
    """RAFT on the CPU with its flow head's last conv at a tenth: at the
    init's scale the random refinements reach flows of tens of px."""
    model = pt.get_model(name, device="cpu", in_normalize=False, **kw)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.1)
    return model


@pytest.mark.parametrize("name,iters", [("raft_things", 12),
                                        ("raft_small", 12)])
def test_raft_on_cuda_matches_cpu(name, iters):
    """RAFT at 96x176 on 3 frame pairs, f32 with TF32 off, against the
    same model on the CPU within 1e-4 of max |flow|; no hand kernel
    runs."""
    dev = _cuda()
    model = _tamed_raft(name, iters=iters)
    frames = _moving_frames(4, 96, 176, torch.Generator().manual_seed(14))
    with torch.inference_mode():
        y_cpu = model(frames[:-1], frames[1:])
        gpu = copy.deepcopy(model).to(dev)
        reset_launch_counts()
        y_gpu = gpu(frames[:-1].to(dev), frames[1:].to(dev))
    assert not any(LAUNCHES.values()), dict(LAUNCHES)
    for g, c in zip(y_gpu, y_cpu):
        err = float((g.cpu() - c).abs().max() / c.abs().max())
        assert err <= 1e-4, err


@pytest.mark.parametrize("radius", [4, 3])
def test_raft_lookups_agree_on_cuda(radius):
    """``lookup_corr`` (banded one-hot products) against
    ``lookup_corr_gather`` (``grid_sample``) on the card at RAFT's 1/8 map
    of 240x432 (30x54; levels 15x27, 7x13, 3x6), coordinates up to 4 px
    off the map, within 1e-5 of max |corr|."""
    dev = _cuda()
    from pytorchcv_tpu_torch.models.raft import (build_corr_pyramid,
                                                 lookup_corr,
                                                 lookup_corr_gather)
    g = torch.Generator().manual_seed(15)
    f1, f2 = (torch.randn(2, 64, 30, 54, generator=g).to(dev)
              for _ in range(2))
    coords = (torch.rand(2, 2, 30, 54, generator=g) * torch.tensor(
        [62.0, 38.0])[None, :, None, None] - 4.0).to(dev)
    with no_tf32():
        pyramid = build_corr_pyramid(f1, f2, 4)
        got = lookup_corr(pyramid, coords, radius)
        ref = lookup_corr_gather(pyramid, coords, radius)
    assert got.shape == (2, 4 * (2 * radius + 1) ** 2, 30, 54)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err


def test_propainter_iterator_on_cuda_matches_cpu():
    """``ProPainterIterator`` from frames and masks over 12 frames of
    96x176 in chunks of 10: raft_small, RFC (its last offset convs at a
    tenth) and the narrow generator on the card, image propagation there
    too, against the same pipeline on the CPU within 1e-4 of max |out|;
    K7 4 launches per generator call (3 calls), K5 2 (l_t - 1) per call on
    the generator's propagation (RFC's 1/8 map, 12x22, is below K5's
    window: its general route), no other kernel; host buffers equal device
    buffers."""
    dev = _cuda()
    from pytorchcv_tpu_torch.models.propainter_stream import (
        ProPainterIterator, TensorSequencer)
    g = torch.Generator().manual_seed(16)
    frames = _moving_frames(12, 96, 176, g)
    masks = (torch.rand((12, 1, 96, 176), generator=g) > 0.9).float()
    raft = _tamed_raft("raft_small", iters=12)
    rfc = pt.get_model("propainter_rfc", device="cpu")
    with torch.no_grad():
        for align in rfc.hg.skip_seq.skip4.feat_prop_module.deform_align \
                .values():
            align.conv_offset.conv4.conv.weight.mul_(0.1)
    gen = _narrow_propainter()

    def run(device, host=False):
        models = [copy.deepcopy(m).to(device) for m in (raft, rfc, gen)]
        it = ProPainterIterator(
            TensorSequencer(frames.to(device)),
            TensorSequencer(masks.to(device)), *models, step=10,
            host_buffers=host, device=device)
        return [torch.as_tensor(c).cpu() for c in it]
    y_cpu = torch.cat(run("cpu"))
    reset_launch_counts()
    y_gpu = run(dev)
    want = {k: 0 for k in LAUNCHES}
    want.update(window_attention=3 * 4, deform_sample=2 * (5 + 10 + 6))
    assert LAUNCHES == want, dict(LAUNCHES)
    err = float((torch.cat(y_gpu) - y_cpu).abs().max() / y_cpu.abs().max())
    assert err <= 1e-4, err
    y_host = run(dev, host=True)
    for h, d in zip(y_host, y_gpu):
        assert torch.equal(h, d)


def _mobilenet_route(name, dev, batch, hw=(256, 256), seed=0):
    """``make_serving_fn(name)`` on the card at seeded weights with BN
    statistics drawn from a generator, and one recorded forward of
    ``batch`` random frames: (serve, raw, calls) with calls by kernel."""
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.quant.mobilenet_int8 as mq
    model = pt.get_model(name, device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.empty(m.num_features).uniform_(
                    0.5, 1.5, generator=g))
                m.running_mean.copy_(torch.empty(m.num_features).normal_(
                    0.0, 0.5, generator=g))
                m.running_var.copy_(torch.empty(m.num_features).uniform_(
                    0.5, 2.0, generator=g))
    serve = pt.make_serving_fn(name, hw, device=dev, model=model)
    raw = torch.randint(0, 256, (batch, *hw, 3), generator=g,
                        dtype=torch.uint8).to(dev)
    calls = {"preprocess": [], "stem": [], "dwconv_i8": [], "int8_conv": []}
    saved = [(pre_mod, "preprocess")] + [
        (mq, n) for n in ("stem_conv", "dwconv_i8", "int8_conv")]
    origs = [getattr(m, n) for m, n in saved]
    keys = ["preprocess", "stem", "dwconv_i8", "int8_conv"]
    for (mod, attr), orig, key in zip(saved, origs, keys):
        def rec(*a, _o=orig, _k=key, **k):
            out = _o(*a, **k)
            calls[_k].append((a, k, out))
            return out
        setattr(mod, attr, rec)
    try:
        reset_launch_counts()
        logits = serve(raw)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        for (mod, attr), orig in zip(saved, origs):
            setattr(mod, attr, orig)
    return serve, raw, calls, launches, logits


@pytest.mark.parametrize("name,gates", [
    ("mobilenetv2_w1", {"stem": 1, "dwconv_i8": 17, "int8_conv": 35}),
    ("mobilenet_w1", {"stem": 1, "dwconv_i8": 13, "int8_conv": 13}),
    ("mobilenetv2_w3d4", {"stem": 1, "dwconv_i8": 17, "int8_conv": 35})])
def test_mobilenet_int8_route_on_cuda(name, gates):
    """The int8 MobileNet routes at batch 32 from 256x256 frames: launch
    counts (K1 1, K3 1, K12 and K2 as read from the model, nothing else),
    K12 and K2 bit-exact against their plain versions at every distinct
    call, K3 (ReLU6 on v2) off by at most 1 in at most 0.1 % of its
    elements, logits at cosine >= 0.99 against the f32 oracle."""
    from pytorchcv_tpu_torch.kernels.dwconv_i8 import dwconv_i8_reference
    dev = _cuda()
    serve, raw, calls, launches, logits = _mobilenet_route(name, dev, 32)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(preprocess=1, **gates)
    assert serve.route == ("mobilenet_v1" if name.startswith("mobilenet_")
                           else "mobilenetv2")
    assert launches == want, launches
    with torch.inference_mode():
        seen = {}
        for a, k, out in calls["dwconv_i8"]:
            seen.setdefault((tuple(a[0].shape), a[5], a[6]), (a, k, out))
        for key, (a, k, out) in seen.items():
            assert torch.equal(out, dwconv_i8_reference(*a, **k)), key
        for a, k, out in calls["int8_conv"]:
            assert torch.equal(out, int8_conv_reference(*a, **k)), (
                tuple(a[0].shape), tuple(a[1].shape), sorted(k))
        (a, k, out), = calls["stem"]
        diff = (out.int() - stem_conv_reference(*a, **k).int()).abs()
        assert diff.max() <= 1 and float((diff != 0).float().mean()) <= 1e-3
        ref = serve.make_reference_forward()(raw).float()
    y = logits.float()
    assert bool(torch.isfinite(y).all())
    cos = float((y * ref).sum() / (y.norm() * ref.norm()))
    assert cos >= 0.99, cos


@pytest.mark.parametrize("c", [8, 24, 36, 96, 108, 20, 6, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv_i8_kernel_matches_plain(c, stride):
    """K12 at odd maps (batch 3, 13x9), channel counts down to one channel
    a thread (C 20, 6, 7), every act, q above, at and below 0 (6 q past
    +-127 too), the plan and every instance the channels allow under 1, 2,
    5 and all output rows a thread (forced through ``_launch``), and on an
    unaligned view: bit-exact."""
    from pytorchcv_tpu_torch.kernels import dwconv_i8 as k12
    dev = _cuda()
    rng = np.random.default_rng(c * 10 + stride)
    x = _i8(rng, (3, 13, 9, c), dev)
    w = _i8(rng, (3, 3, c), dev)
    a = torch.from_numpy(rng.uniform(1e-3, 3e-3, c).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(dev)
    ho = (13 - 1) // stride + 1
    for act, q in itertools.product((None, "relu", "relu6"),
                                    (0.9, 90.0, 0.0, -0.9, -90.0)):
        ref = k12.dwconv_i8_reference(x, w, a, b, q, stride, act)
        reset_launch_counts()
        got = k12.dwconv_i8(x, w, a, b, q, stride, act)
        torch.cuda.synchronize()
        assert LAUNCHES["dwconv_i8"] == 1 and torch.equal(got, ref)
        for cpt, s in k12.INSTANCES:
            if s != stride or c % cpt:
                continue
            for rows in (1, 2, 5, ho):
                plan = k12.K12Plan(cpt, rows)
                got = k12._launch(x, w, a, b, q, stride, act,
                                  torch.empty_like(ref), plan)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (plan, act, q)
    base = torch.empty(x.numel() + 1, dtype=torch.int8, device=dev)
    xu = base[1:].view(x.shape)
    xu.copy_(x)
    got = k12.dwconv_i8(xu, w, a, b, 0.9, stride)
    assert torch.equal(got, k12.dwconv_i8_reference(x, w, a, b, 0.9,
                                                    stride))


def test_dwconv_i8_instances_spill_nothing():
    from pytorchcv_tpu_torch.kernels.dwconv_i8 import INSTANCES, kernel_info
    _cuda()
    for cpt, stride in INSTANCES:
        info = kernel_info(cpt, stride)
        assert info["spill_bytes"] == 0, info


@pytest.mark.parametrize("groups", [1, 8])
def test_int8_conv_mobilenet_modes_match_plain(groups):
    """K2's ReLU6, linear-residual and f32-output epilogues, dense and
    grouped, at sizes no tile divides: bit-exact."""
    dev = _cuda()
    rng = np.random.default_rng(groups)
    cin, cout, k = (20, 36, 1) if groups == 1 else (64, 48, 3)
    x = _i8(rng, (3, 11, 7, cin), dev)
    w = _i8(rng, (cout, k, k, cin // groups), dev)
    a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    res = _i8(rng, (3, 11, 7, cout), dev)
    cases = [dict(act="relu6", q=0.7), dict(act="relu6", out_f32=True),
             dict(act="relu", out_f32=True), dict(act=None, out_f32=True),
             dict(act=None, q=0.7, residual=res, res_scale=0.01,
                  linear_res=True)]
    for kw in cases:
        got = int8_conv(x, w, a, b, groups=groups, **kw)
        ref = int8_conv_reference(x, w, a, b, groups=groups, **kw)
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype and torch.equal(got, ref), sorted(kw)


def test_stem_relu6_matches_plain():
    """K3 with ReLU6 at the MobileNet stems' shape (3x3/s2, 224 -> 112,
    Cout 32, 24, 16 and 8): at most 0.1 % of elements off by 1."""
    dev = _cuda()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 3, 224, 224), generator=g).to(dev, torch.bfloat16)
    for cout in (32, 24, 16, 8):
        kf = (torch.randn((3, 3, 3, cout), generator=g) * 0.4).to(
            dev, torch.bfloat16)
        bias = torch.randn(cout, generator=g).to(dev)
        for act in ("relu6", "relu"):
            got = stem_conv(x, kf, bias, 30.0, act)
            ref = stem_conv_reference(x, kf, bias, 30.0, act)
            torch.cuda.synchronize()
            diff = (got.int() - ref.int()).abs()
            assert diff.max() <= 1, (cout, act)
            assert float((diff != 0).float().mean()) <= 1e-3, (cout, act)


@pytest.mark.parametrize("name,mode,k6,acts", [
    ("mobilenetv3_large_w1", "auto", 15, {"relu", "hswish_div"}),
    ("mobilenetv2_w1", "bf16", 17, {"relu6"}),
    ("mobilenet_w1", "bf16", 13, {"relu"})])
def test_dwconv_mobilenet_bf16_calls_match_plain(name, mode, k6, acts,
                                                 monkeypatch):
    """K6 at every depthwise call of a bf16 MobileNet forward (MobileNetV3-
    large's auto route: 3x3 and 5x5, ReLU and the dividing hswish; the int8
    names' ``mode="bf16"`` routes: 3x3, ReLU6 on v2, ReLU on v1; stride 1
    and 2) and again in f32: f32 bit-exact, bf16 within 1 bf16 ulp; K6
    once a depthwise block, K1 once, nothing else."""
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    dev = _cuda()
    calls = []

    def rec(*a, **k):
        out = dwconv2d_bn_act(*a, **k)
        calls.append((a, out))
        return out
    serve = pt.make_serving_fn(name, (256, 256), mode=mode, device=dev)
    assert serve.route == "bf16"
    raw = torch.randint(0, 256, (8, 256, 256, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4)).to(dev)
    monkeypatch.setattr(conv_mod, "dwconv2d_bn_act", rec)
    reset_launch_counts()
    serve(raw)
    torch.cuda.synchronize()
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(preprocess=1, dwconv=k6)
    assert dict(LAUNCHES) == want
    assert {a[6] for a, _ in calls} == acts
    with torch.inference_mode():
        for a, out in calls:
            ref = dwconv2d_bn_act_reference(*a)
            assert float(bf16_ulp_error(out, ref).max()) <= 1, a[6]
            a32 = (a[0].float(), a[1].float(), *a[2:])
            assert torch.equal(dwconv2d_bn_act(*a32),
                               dwconv2d_bn_act_reference(*a32)), a[6]


# ------------------------------------------------ dense-prediction routes

def test_int8_conv_bend_at_the_seg_backbone_shape():
    """The bend: stage 3's last conv of ResNet(D)-101b at 480x480 (x 60x60,
    256 -> 1024, the unit's own int8 input as residual, rounded to bf16)
    writes int8 at the next scale and the bf16 sum in one launch, both
    equal to the plain version's, the int8 output also to the launch
    without the bend."""
    dev = _cuda()
    rng = np.random.default_rng(60)
    x = _i8(rng, (2, 60, 60, 256), dev)
    w = _i8(rng, (1024, 1, 1, 256), dev)
    a = torch.from_numpy(rng.uniform(2e-5, 2e-4, 1024).astype(np.float32)
                         ).to(dev)
    b = torch.from_numpy(rng.standard_normal(1024).astype(np.float32)).to(dev)
    kw = dict(act=None, q=0.7, residual=_i8(rng, (2, 60, 60, 1024), dev),
              res_scale=0.01, round_res=True)
    reset_launch_counts()
    got = int8_conv(x, w, a, b, 1, bend=True, **kw)
    assert LAUNCHES["int8_conv"] == 1
    ref = int8_conv_reference(x, w, a, b, 1, bend=True, **kw)
    plain = int8_conv(x, w, a, b, 1, **kw)
    torch.cuda.synchronize()
    assert got[1].dtype == torch.bfloat16
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert torch.equal(got[0], plain)


@pytest.mark.parametrize("bsz,h,w", [(4, 256, 192), (2, 512, 512)])
def test_stem_kernel_at_the_pose_and_detection_shapes(bsz, h, w):
    """K3's 7x7 on the pose crops (256x192, not square) and CenterNet's
    frames (512x512): within the gate; no spill."""
    from pytorchcv_tpu_torch.kernels import stem as k3
    dev = _cuda()
    rng = np.random.default_rng(h + w)
    x = torch.from_numpy(rng.standard_normal((bsz, 3, h, w)).astype(
        np.float32)).to(dev, torch.bfloat16)
    kf = torch.from_numpy((rng.standard_normal((3, 7, 7, 64)) * 0.1)
                          .astype(np.float32)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                            ).to(dev)
    got = stem_conv(x, kf, bias, 40.0)
    ref = stem_conv_reference(x, kf, bias, 40.0)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (bsz, h // 2, w // 2, 64)
    diff = (got.int() - ref.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) <= 1e-3
    info = k3.kernel_info(bsz, h, w, 7)
    assert info["spill_bytes"] == 0 and info["registers"] <= 128, info


@pytest.mark.parametrize("hw,c", [((64, 48), 256), ((32, 24), 512),
                                  ((16, 12), 1024), ((8, 6), 2048)])
def test_se_tail_kernel_at_alphapose_shapes(hw, c):
    """K11 at the SE units of AlphaPose's trunk (unit 1 of each stage at
    256x192, batch 32: an int8 identity conv at the next unit's scale):
    bit-exact against the plain version handed the same gate."""
    from pytorchcv_tpu_torch.kernels.se_tail import (se_tail,
                                                     se_tail_reference)
    dev = _cuda()
    rng = np.random.default_rng(c)
    shape = (32, *hw, c)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3
                         ).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.uniform(0, 1, (32, c)).astype(np.float32)
                         ).to(dev)
    kw = dict(residual=_i8(rng, shape, dev), res_scale=0.02, q=0.9)
    got = se_tail(t, g, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, se_tail_reference(t, g, **kw))


def _tied(shape, levels, seed, dev, dtype):
    rng = np.random.default_rng(seed)
    x = rng.choice(np.float32(levels), shape)
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decodes_on_cuda_match_cpu(dtype):
    """Both decodes on the card equal the same tensor's decode on the CPU,
    exactly, on maps full of ties: the keypoint block at the pose routes'
    heatmaps (32, 17, 64, 48) and CenterNet's top-k at its (2, 84, 128,
    128) tensor (the 80 class maps on four score levels: every slot past
    the first few is a tie, ranked by the lower flat index)."""
    from pytorchcv_tpu_torch.models.centernet import \
        centernet_heatmap_max_det
    from pytorchcv_tpu_torch.nn import HeatmapMaxDetBlock
    dev = _cuda()
    hm = _tied((32, 17, 64, 48), [-0.5, 0.0, 0.25, 0.5, 1.0], 1, dev, dtype)
    got = HeatmapMaxDetBlock()(hm)
    assert torch.equal(got.cpu(), HeatmapMaxDetBlock()(hm.cpu()))
    x = torch.randn((2, 84, 128, 128), generator=torch.Generator()
                    .manual_seed(2)).to(dev, dtype)
    x[:, :80] = _tied((2, 80, 128, 128), [0.0, 0.25, 0.5, 1.0], 3, dev,
                      dtype)
    got = centernet_heatmap_max_det(x)
    want = centernet_heatmap_max_det(x.cpu())
    assert torch.equal(got.cpu(), want)
    assert bool((got[..., 5] == 1.0).all())        # all 40 are ties at 1.0


@pytest.mark.parametrize("name,task,hw,src,tol", [
    ("pspnet_resnetd50b_voc", "segmentation", (64, 64), (75, 100), 0.999),
    ("simplepose_resnet18_coco", "pose", (64, 48), (80, 60), 0.999),
    ("alphapose_fastseresnet101b_coco", "pose", (64, 48), (80, 60), 0.99),
    ("centernet_resnet18_voc", "detection", (128, 128), (120, 160), 0.999)])
def test_dense_routes_on_cuda_match_cpu(name, task, hw, src, tol):
    """The dense int8 routes on the card against the CPU on the same
    weights and calibration: the pre-decode outputs at cosine >= 0.999 (a
    K3 element off by 1 moves a few requantized values a step), AlphaPose's
    at 0.99, the routes' gate against the f32 oracle (its SE gates' f32
    mean and products sum in another order on the card, a gate one ulp
    apart moves a requantized value a step, and its 101-layer trunk
    carries such steps on: 0.9958 on the H100); launches K1 / K3 /
    ``maxpool_i8`` 1 and K2 (+ K11) as the plan counts them."""
    dev = _cuda()
    kw = {"return_heatmap": True} if task != "segmentation" else {}
    model = pt.get_model(name, in_size=hw, device="cpu", **kw)
    raw = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, *src, 3), dtype=np.uint8))
    from pytorchcv_tpu_torch.kernels.preprocess import \
        segmentation_preprocess
    calib = segmentation_preprocess(hw, src, layout="nchw", device="cpu")(
        raw).float()
    serve_cpu = pt.make_serving_fn(name, src, task=task, device="cpu",
                                   model=model, calib_batches=[calib])
    serve_gpu = pt.make_serving_fn(name, src, task=task, device=dev,
                                   model=copy.deepcopy(model).to(dev),
                                   calib_batches=[calib.to(dev)])
    y_cpu = serve_cpu(raw)
    reset_launch_counts()
    y_gpu = serve_gpu(raw.to(dev))
    torch.cuda.synchronize()
    units = [m for m in model.backbone.modules() if hasattr(m, "body")]
    n_k2 = sum(len(list(u.body.children())) + (u.identity_conv is not None)
               for u in units) + (2 if task == "segmentation" else 0)
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(preprocess=1, stem=1, maxpool_i8=1, int8_conv=n_k2,
                se_tail=sum(getattr(u, "se", None) is not None
                            for u in units))
    assert dict(LAUNCHES) == want
    for a, b in zip(*(y if isinstance(y, tuple) else (y,)
                      for y in (y_cpu, y_gpu))):
        cos = float(torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().cpu().flatten(), dim=0))
        assert cos >= tol, cos
