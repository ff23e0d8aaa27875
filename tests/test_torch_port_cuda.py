"""The port's CUDA kernels against their plain PyTorch versions on shapes
the serving paths do not give them: partial output tiles, reduction tails,
odd image sizes, dilations on odd sizes, narrow models, the bf16 residual
of a last unit with an identity conv, attention at sequence lengths and
widths no tile divides, and the deformable sampler at widths that are not
multiples of 8, with windows across every border and element counts no
block divides.

Each test carries the ``cuda`` marker, needs a CUDA card and nvcc, and
skips without a card. On a machine without JAX, run them without the
suite's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_port_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

import pytorchcv_tpu_torch as pt
from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from pytorchcv_tpu_torch.kernels.deform_patch import (deform_sample,
                                                      deform_sample_reference)
from pytorchcv_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                   int8_conv_reference)
from pytorchcv_tpu_torch.kernels.preprocess import (
    bf16_ulp_distance, bf16_ulp_error, classification_preprocess, preprocess,
    preprocess_reference, resize_matrices)
from pytorchcv_tpu_torch.kernels.stem import (maxpool_i8, maxpool_i8_reference,
                                              stem_conv, stem_conv_reference)
from pytorchcv_tpu_torch.nn.deform import deform_conv2d
from pytorchcv_tpu_torch.quant import calibrate_int8, prepare_int8_resnet

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
    cases = [dict(relu=True, q=0.7), dict(relu=False, q=0.7),
             dict(relu=True), dict(relu=False),
             dict(relu=False, q=0.7, residual=res_i8, res_scale=0.01,
                  round_res=True),
             dict(relu=False, q=0.7, residual=res_i8, res_scale=0.01),
             dict(relu=False, residual=res_bf)]
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
    for kw in (dict(relu=True, q=0.7), dict(relu=False),
               dict(relu=False, q=0.7, residual=res, res_scale=0.01,
                    round_res=True, bend=True)):
        got = int8_conv(x, w, a, b, 1, dilation=dilation, **kw)
        ref = int8_conv_reference(x, w, a, b, 1, dilation=dilation, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g_, r_ in zip(got, ref):
            assert torch.equal(g_, r_), (kw.keys(), (g_.float() - r_.float())
                                         .abs().max())


@pytest.mark.parametrize("lq", [63, 401, 3600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(lq, dtype):
    """bf16 within 1 ulp (``bf16_ulp_error``: outputs that average to near
    zero round apart in f32); f32 within 1e-4 of the largest plain
    value."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(lq)
    for d, dv in ((32, 96), (64, 512)):
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


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_preprocess_kernel_matches_plain(layout):
    dev = _cuda()
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 50, 70, 3),
                                         dtype=np.uint8)).to(dev)
    r, c = resize_matrices((50, 70), 33)
    r_t = torch.from_numpy(r).to(dev)
    ct_t = torch.from_numpy(np.ascontiguousarray(c.T)).to(dev)
    a = torch.tensor([0.017, 0.018, 0.019], device=dev)
    b = torch.tensor([-2.1, -2.0, -1.8], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        got = preprocess(imgs, r_t, ct_t, a, b, dtype, layout)
        ref = preprocess_reference(imgs, r_t, ct_t, a, b, dtype, layout)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        else:
            assert int(bf16_ulp_distance(got, ref).max()) <= 1


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


@pytest.mark.parametrize("name,kw,n_convs", [
    ("resnet10", {}, 11), ("resnet50", {"width_scale": 0.25}, 53)])
def test_int8_pipeline_on_cuda_matches_cpu(name, kw, n_convs):
    """Narrow and basic-block models end in a unit with an identity conv,
    the bf16-residual tail. The CUDA pipeline matches the CPU one on the
    same weights and scales."""
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
                        "deform_sample": 0}
    cos = float(torch.nn.functional.cosine_similarity(
        y_gpu.flatten(), y_cpu.flatten(), dim=0))
    assert cos >= 0.9999, cos


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
