#!/usr/bin/env python3
"""GPU smoke test of pytorchcv_tpu_torch: int8 ResNet-50 classification,
int8 DANet (ResNet-D50b) Cityscapes segmentation serving and ProPainter
recurrent flow completion (RFC) streaming, on the port's hand-written CUDA
kernels.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels from ``csrc/`` at first
use (one nvcc per source, in parallel). Phases, each ending in
``torch.cuda.synchronize()``:

1. device and build: the card (nvidia-smi name and power limit), torch and
   CUDA versions, the kernel build time;
2. ResNet-50 kernels vs their plain PyTorch versions, on the inputs one
   batch-32 forward (256x256 frames, crop 224) gives them: preprocess (K1)
   within 1 bf16 ulp, every distinct int8 conv (K2) bit-exact, the 7x7
   stem conv (K3) with at most 0.1 % of elements off by 1, ``maxpool_i8``
   bit-exact;
3. the ResNet-50 slice: ``make_serving_fn("resnet50", (256, 256),
   device="cuda")`` on seeded random weights (BN statistics randomized by
   an explicit generator); one batch with launch counts K1 = 1, K3 = 1,
   ``maxpool_i8`` = 1, K2 = 52, finite (B, 1000) logits, cosine >= 0.99
   against the f32 reference forward (no TF32);
4. ResNet-50 timing with CUDA events at batch 128: serving images/s, and
   each kernel beside its plain version and its library call;
5. DANet kernels vs their plain versions, on the inputs one batch-2
   forward of 1024x2048 frames (resized to 480x480) gives them, and on
   calibration's f32 attention: K1 within 1 bf16 ulp, every distinct K2
   conv bit-exact (dilated ones included, and one stage-3 tail conv again
   with the bend output, which DANet's head does not read), the 3x3 K3
   with at most 0.1 % of elements off by 1, ``maxpool_i8`` bit-exact, flash
   attention (K4) within 1 bf16 ulp (bf16) and 1e-4 relative (f32), also
   with the path's q scaled so that the softmax spreads, and at an L no
   tile divides;
6. the DANet slice: ``make_serving_fn("danet_resnetd50b_cityscapes",
   (1024, 2048), task="segmentation", device="cuda")`` on seed-0 weights,
   BN and every ScaleBlock alpha randomized from seed 1 (alpha's zero init
   would make both attention branches the identity); launch counts
   K1 = 1, K3 = 1, maxpool_i8 = 1, K2 = 54, K4 = 1; three finite
   (B, 19, 480, 480) maps; main map cosine >= 0.99 and per-pixel argmax
   agreement >= 0.97 against the f32 reference forward (no TF32);
7. DANet timing at batch 8: serving images/s, each kernel beside its plain
   version and its library call (SDPA beside K4), and the cuDNN bf16 head
   convs (recorded through the closure's ``head``);
8. the RFC slice: ``get_model("propainter_rfc", device="cuda")`` on seed-0
   weights completes the flows of a synthetic 160-frame 240x432 clip
   (smooth sinusoidal flows up to 10 px, a moving ellipse masking ~10 % of
   each frame) through ``ProPainterRFCSequencer`` (window 80, padding 5:
   two windows, printed); launch counts K5 = sum over windows of
   4 (T_w - 1) and no other kernel; finite (159, 4, 240, 432) flows, equal
   to the input outside the masks;
9. K5 (deformable sampling) against its plain version at every distinct
   shape of the path (f32, within 1e-5 of max|x|) and at the flow-guided
   shape (1, 128, 60, 108), G 16, residue bound 3, centers of std 6
   (f32 as above, bf16 within 1 bf16 ulp at the tensor's scale);
10. end to end: the completed flows against the same model with
   ``deform_conv2d`` patched here to its general route, max |delta| <= 1e-3
   of max |flow| (f32, no TF32); and the card against a CPU copy of the
   model (plain sampler) on the clip's first 3 flows, within 1e-4 of max
   |flow| (on random weights the recurrence grows over the clip: the
   window's flows reach ~6e11, and the JAX model grows alike);
11. RFC timing with CUDA events: completed-flow frames/s over the clip and
   per window, K5 a call beside its plain version and ``F.grid_sample``
   times the mask, and one RFC call split into its 3-D and 2-D convs and
   K5.

Any failure raises. The last lines are the card, the kernels' JSON record
(one entry per kernel and path) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import torch

BATCH_CHECK = 32
BATCH_TIME = 128
SOURCE_HW = (256, 256)
STEM_TOLERANCE = 1e-3          # share of int8 elements allowed off by 1

SEG_NAME = "danet_resnetd50b_cityscapes"
SEG_SOURCE_HW = (1024, 2048)   # native Cityscapes frames
SEG_BATCH_CHECK = 2
SEG_BATCH_TIME = 8
SEG_LAUNCHES = {"preprocess": 1, "stem": 1, "maxpool_i8": 1, "int8_conv": 54,
                "flash_attention": 1, "deform_sample": 0}
ATTN_F32_RTOL = 1e-4           # K4 f32: max |err| / max |plain|

RFC_HW = (240, 432)            # ProPainter's default input
RFC_FRAMES = 160               # two windows of 80 frames
RFC_WINDOW, RFC_PADDING = 80, 5
RFC_FLOW_GUIDED = ((1, 128, 60, 108), 16, 3.0)   # x shape, G, residue bound
RFC_F32_TOL = 1e-5             # K5 f32: max |err| / max |x|
RFC_E2E_TOL = 1e-3             # completed flows: max |delta| / max |flow|
RFC_SHORT = 3                  # flows of the card-vs-CPU check
RFC_CPU_TOL = 1e-4             # its max |delta| / max |flow|

# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): HBM bytes/s and
# operations/s by operand type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
SRC = "pytorchcv_tpu_torch/csrc/"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _require(ok: bool, msg) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _randomize_bn(model: torch.nn.Module, seed: int) -> None:
    """BN scale/bias/mean/var from an explicit generator: channel-constant
    statistics would hide a per-channel fault in the folding. The same
    generator then draws every ScaleBlock alpha as +-U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=g))
                m.bias.copy_(torch.empty(c).normal_(0.0, 0.1, generator=g))
                m.running_mean.copy_(
                    torch.empty(c).normal_(0.0, 0.5, generator=g))
                m.running_var.copy_(
                    torch.empty(c).uniform_(0.5, 2.0, generator=g))
        for m in model.modules():
            if hasattr(m, "alpha"):
                mag = torch.empty(1).uniform_(0.5, 1.5, generator=g)
                sign = 1.0 if float(torch.rand(1, generator=g)) < 0.5 else -1.0
                m.alpha.copy_(mag * sign)


def _raw_batch(n: int, seed: int, hw=SOURCE_HW) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=g,
                         dtype=torch.uint8).cuda()


@contextlib.contextmanager
def _recording(targets):
    """Record every call (args, kwargs, output) of the wrappers named in
    ``targets`` ((module, attribute, key) triples), by key."""
    calls = {key: [] for _, _, key in targets}
    saved = []
    for mod, attr, key in targets:
        orig = getattr(mod, attr)
        saved.append((mod, attr, orig))

        def rec(*a, _orig=orig, _key=key, **k):
            out = _orig(*a, **k)
            calls[_key].append((a, k, out))
            return out
        setattr(mod, attr, rec)
    try:
        yield calls
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def _resnet_targets():
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    return [(pre_mod, "preprocess", "preprocess"),
            (rq, "int8_conv", "int8_conv"),
            (rq, "stem_conv", "stem"),
            (rq, "maxpool_i8", "maxpool_i8")]


def _seg_targets():
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.models.danet as danet_mod
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    import pytorchcv_tpu_torch.quant.seg_backbone_int8 as sq
    return [(pre_mod, "preprocess", "preprocess"),
            (rq, "int8_conv", "int8_conv"),
            (sq, "stem_conv", "stem"),
            (sq, "maxpool_i8", "maxpool_i8"),
            (danet_mod, "flash_attention", "flash_attention")]


def _conv_key(a, k):
    x, w = a[0], a[1]
    res = k.get("residual")
    mode = ("int8" if k["q"] is not None else "bf16",
            "relu" if k["relu"] else "linear",
            "no-res" if res is None else
            f"res-{str(res.dtype)[6:]}{'-bf16round' if k.get('round_res') else ''}")
    if k.get("bend"):
        mode += ("bend",)
    return (w.shape[1], k["stride"], k.get("dilation", 1), x.shape[3],
            w.shape[0], x.shape[1], "/".join(mode))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _work_preprocess(a, out):
    """R X C^T needs only the non-zero taps of the banded resize matrices,
    multiplied in the cheaper of the two orders."""
    images, r, ct = a[0], a[1], a[2]
    bsz, h, w, c = images.shape
    oh, ow = r.shape[0], ct.shape[1]
    nr, nc = int(torch.count_nonzero(r)), int(torch.count_nonzero(ct))
    macs = min(nr * w + nc * oh, nc * h + nr * ow)
    return _bound(_nbytes(*a[:5], out), 2 * bsz * c * macs, "f32")


def _work_stem(a, k, out):
    x, kf = a[0], a[1]
    bsz, _, h, w = x.shape
    ks, cout = kf.shape[1], kf.shape[3]
    ho, wo = (h + 2 * (ks // 2) - ks) // 2 + 1, (w + 2 * (ks // 2) - ks) // 2 + 1
    ops = 2 * bsz * ho * wo * cout * 3 * ks * ks
    return _bound(_nbytes(x, kf, a[2], out), ops, "bf16")


def _work_pool(a, out):
    return _bound(_nbytes(a[0], out), 9 * out.numel(), "int8")


def _work_convs(calls):
    nbytes = ops = 0
    for a, k, out in calls:
        x, w = a[0], a[1]
        outs = out if isinstance(out, tuple) else (out,)
        nbytes += _nbytes(x, w, a[2], a[3], k.get("residual"), *outs)
        o = outs[0]
        ops += 2 * o.shape[0] * o.shape[1] * o.shape[2] * o.shape[3] * \
            w.shape[1] * w.shape[2] * w.shape[3]
    return _bound(nbytes, ops, "int8")


def _work_attention(a, out):
    q, k, v = a[:3]
    n = q.numel() // (q.shape[-2] * q.shape[-1])
    ops = 2 * n * q.shape[-2] * k.shape[-2] * (q.shape[-1] + v.shape[-1])
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    return _bound(_nbytes(q, k, v, out), ops, kind)


def _check_preprocess(calls, max_err, tag, scaled=False):
    """K1 within 1 bf16 ulp of its plain version: per element, or with
    ``scaled`` the ulp taken no finer than at 1/256 of the largest value
    (``bf16_ulp_error``: the normalization's affine cancels to near zero
    on some pixels, where the two f32 summation orders round apart)."""
    from pytorchcv_tpu_torch.kernels.preprocess import (bf16_ulp_distance,
                                                        bf16_ulp_error,
                                                        preprocess_reference)
    (a, k, out), = calls
    ref = preprocess_reference(*a, **k)
    per_elem = int(bf16_ulp_distance(out, ref).max())
    ulp = float(bf16_ulp_error(out, ref).max()) if scaled else per_elem
    max_err["preprocess"] = float((out.float() - ref.float()).abs().max())
    print(f"{tag} K1 preprocess {tuple(a[0].shape)} -> {tuple(out.shape)} "
          f"{out.dtype}: max {ulp} bf16 ulp{' (scaled)' if scaled else ''}, "
          f"per element {per_elem}, max abs err {max_err['preprocess']}")
    _require(ulp <= 1, f"{tag} K1 differs by {ulp} bf16 ulp")


def _check_stem(calls, max_err, tag):
    from pytorchcv_tpu_torch.kernels.stem import stem_conv_reference
    (a, k, out), = calls
    ref = stem_conv_reference(*a, **k)
    diff = (out.int() - ref.int()).abs()
    share = float((diff != 0).float().mean())
    max_err["stem"] = float(diff.max())
    print(f"{tag} K3 stem {tuple(a[1].shape[1:3])} {tuple(a[0].shape)} -> "
          f"{tuple(out.shape)}: {share:.6f} of elements differ, max diff "
          f"{max_err['stem']}")
    _require(max_err["stem"] <= 1 and share <= STEM_TOLERANCE,
             f"{tag} K3 off by {max_err['stem']} on a share {share}")


def _check_pool(calls, max_err, tag):
    from pytorchcv_tpu_torch.kernels.stem import maxpool_i8_reference
    (a, k, out), = calls
    ref = maxpool_i8_reference(*a, **k)
    max_err["maxpool_i8"] = float((out.float() - ref.float()).abs().max())
    print(f"{tag} maxpool_i8 {tuple(a[0].shape)} -> {tuple(out.shape)}: "
          f"{'bit-exact' if torch.equal(out, ref) else 'DIFFERS'}")
    _require(torch.equal(out, ref), f"{tag} maxpool_i8 not bit-exact")


def _check_convs(calls, max_err, tag):
    from pytorchcv_tpu_torch.kernels.int8_conv import int8_conv_reference
    seen = {}
    for a, k, out in calls:
        seen.setdefault(_conv_key(a, k), (a, k, out))
    max_err["int8_conv"] = 0.0
    for key, (a, k, out) in sorted(seen.items()):
        ref = int8_conv_reference(*a, **k)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        same = all(torch.equal(o, r) for o, r in zip(outs, refs))
        for o, r in zip(outs, refs):
            max_err["int8_conv"] = max(max_err["int8_conv"], float(
                (o.float() - r.float()).abs().max()))
        print(f"{tag} K2 k={key[0]} s={key[1]} d={key[2]} cin={key[3]} "
              f"cout={key[4]} h={key[5]} {key[6]}: "
              f"{'bit-exact' if same else 'DIFFERS'}")
        _require(same, f"{tag} K2 not bit-exact at {key}")
    print(f"{tag} K2: {len(seen)} distinct convs of {len(calls)} bit-exact")


def _check_bend(calls, max_err):
    """K2's bend output at the path's shapes: the last stage-3 tail conv
    (1x1 to 1024 channels, int8 residual) launched again with ``bend``. Its
    int8 output equals the path's, and both outputs their plain versions."""
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    a, k, out = [c for c in calls if c[1].get("round_res")
                 and c[0][1].shape[0] == 1024][-1]
    kb = dict(k, bend=True)
    got, ref = int8_conv(*a, **kb), int8_conv_reference(*a, **kb)
    same = torch.equal(got[0], out) and all(
        torch.equal(g, r) for g, r in zip(got, ref))
    for g, r in zip(got, ref):
        max_err["int8_conv"] = max(max_err["int8_conv"], float(
            (g.float() - r.float()).abs().max()))
    print(f"danet K2 bend x {tuple(a[0].shape)} -> int8 "
          f"{tuple(got[0].shape)}, bf16 {tuple(got[1].shape)}: "
          f"{'bit-exact' if same else 'DIFFERS'}")
    _require(same, "danet K2 bend output not bit-exact")


def _check_attention(q, k, v, out, what):
    """K4 against its plain version: bf16 within 1 ulp (``bf16_ulp_error``:
    outputs that average to near zero round apart in f32), f32 within
    ATTN_F32_RTOL of the largest plain value. Returns the max abs error."""
    from pytorchcv_tpu_torch.kernels.flash_attention import \
        flash_attention_reference
    from pytorchcv_tpu_torch.kernels.preprocess import (bf16_ulp_distance,
                                                        bf16_ulp_error)
    ref = flash_attention_reference(q, k, v, 1.0)
    err = float((out.float() - ref.float()).abs().max())
    if q.dtype == torch.bfloat16:
        ulp = float(bf16_ulp_error(out, ref).max())
        print(f"K4 {what} bf16 q {tuple(q.shape)} v {tuple(v.shape)}: max "
              f"{ulp} bf16 ulp (scaled), per element "
              f"{int(bf16_ulp_distance(out, ref).max())}, max abs err {err}")
        _require(ulp <= 1, f"K4 {what} differs by {ulp} bf16 ulp")
    else:
        rel = err / float(ref.abs().max())
        print(f"K4 {what} f32 q {tuple(q.shape)} v {tuple(v.shape)}: max "
              f"rel err {rel:.3e}, max abs err {err}")
        _require(rel <= ATTN_F32_RTOL, f"K4 {what} f32 rel err {rel}")
    return err


def _record_entry(name, path, source, replaces, launches, max_err, ms,
                  plain_ms, bound, library_ms):
    return {"name": name, "path": path, "route": "cuda",
            "source": SRC + source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _resnet(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.preprocess import (preprocess,
                                                        preprocess_reference)
    from pytorchcv_tpu_torch.kernels.stem import (maxpool_i8,
                                                  maxpool_i8_reference,
                                                  stem_conv,
                                                  stem_conv_reference)
    import torch.nn.functional as F

    # -- 2. kernels vs plain versions at the main path's shapes
    model = pt.get_model("resnet50", rng=0, device="cuda")
    _randomize_bn(model, seed=1)
    t0 = time.perf_counter()
    serve = pt.make_serving_fn("resnet50", SOURCE_HW, device="cuda",
                               model=model)
    torch.cuda.synchronize()
    print(f"serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s")
    raw = _raw_batch(BATCH_CHECK, seed=2)
    with _recording(_resnet_targets()) as calls:
        serve(raw)
    torch.cuda.synchronize()
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, "resnet50")
        _check_stem(calls["stem"], max_err, "resnet50")
        _check_pool(calls["maxpool_i8"], max_err, "resnet50")
        _check_convs(calls["int8_conv"], max_err, "resnet50")
    del calls
    torch.cuda.synchronize()

    # -- 3. the slice, with launch counts
    reset_launch_counts()
    logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"resnet50 launches in one forward: {launches}")
    _require(launches == {"preprocess": 1, "stem": 1, "int8_conv": 52,
                          "maxpool_i8": 1, "flash_attention": 0,
                          "deform_sample": 0}, launches)
    _require(tuple(logits.shape) == (BATCH_CHECK, 1000), logits.shape)
    y = logits.float()
    _require(bool(torch.isfinite(y).all()), "non-finite logits")
    yf = serve.make_reference_forward()(raw).float()
    torch.cuda.synchronize()
    cos = float((y * yf).sum() / (y.norm() * yf.norm()))
    top1 = float((y.argmax(1) == yf.argmax(1)).float().mean())
    print(f"int8 vs f32 reference: cosine {cos:.6f}, top-1 agreement {top1}")
    _require(cos >= 0.99, f"cosine {cos} < 0.99")

    # -- 4. timing at batch 128
    raw128 = _raw_batch(BATCH_TIME, seed=3)
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw128), reps=10, warmup=3)
        print(f"[{card}] serving resnet50 int8 batch {BATCH_TIME}: "
              f"{ms_serve:.3f} ms/batch, "
              f"{BATCH_TIME * 1000.0 / ms_serve:.1f} img/s")
        with _recording(_resnet_targets()) as calls128:
            serve(raw128)
        torch.cuda.synchronize()
        t = {}
        (a, k, out), = calls128["preprocess"]
        r, ct = a[1], a[2]
        x32 = a[0].permute(0, 3, 1, 2).float()
        t["preprocess"] = (
            _cuda_ms(lambda: preprocess(*a, **k), 20),
            _cuda_ms(lambda: preprocess_reference(*a, **k), 20),
            _cuda_ms(lambda: torch.einsum("oh,bchw,wp->bcop", r, x32, ct),
                     20), _work_preprocess(a, out))
        (a, k, out), = calls128["stem"]
        xs = a[0].float()
        ws = a[1].permute(3, 0, 1, 2).float()
        t["stem"] = (
            _cuda_ms(lambda: stem_conv(*a, **k), 20),
            _cuda_ms(lambda: stem_conv_reference(*a, **k), 5),
            _cuda_ms(lambda: F.conv2d(xs, ws, stride=2, padding=3), 20),
            _work_stem(a, k, out))
        del xs
        (a, k, out), = calls128["maxpool_i8"]
        t["maxpool_i8"] = (
            _cuda_ms(lambda: maxpool_i8(*a, **k), 20),
            _cuda_ms(lambda: maxpool_i8_reference(*a, **k), 20), None,
            _work_pool(a, out))
        convs = [(a, k) for a, k, _ in calls128["int8_conv"]]
        conv_bound = _work_convs(calls128["int8_conv"])
        del calls128
        t["int8_conv"] = (
            _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs], 5),
            _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                              for a, k in convs], 2, warmup=1),
            None, conv_bound)
    for name, (ms, plain, lib, bound) in t.items():
        what = "52 convs of one forward" if name == "int8_conv" else "one call"
        print(f"[{card}] resnet50 {name} batch {BATCH_TIME} ({what}): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
    replaces = {"preprocess": ("preprocess.cu",
                               "pytorchcv_tpu/kernels/preprocess.py:133"),
                "int8_conv": ("int8_conv.cu",
                              "pytorchcv_tpu/quant/resnet_int8.py:66"),
                "stem": ("stem.cu", "pytorchcv_tpu/quant/resnet_int8.py:253"),
                "maxpool_i8": ("stem.cu",
                               "pytorchcv_tpu/quant/resnet_int8.py:261")}
    for name, (source, rep) in replaces.items():
        ms, plain, lib, bound = t[name]
        record.append(_record_entry(name, "resnet50", source, rep,
                                    launches[name], max_err[name], ms, plain,
                                    bound, lib))


def _danet(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.preprocess import (preprocess,
                                                        preprocess_reference)
    from pytorchcv_tpu_torch.kernels.stem import (maxpool_i8,
                                                  maxpool_i8_reference,
                                                  stem_conv,
                                                  stem_conv_reference)

    # -- 5. kernels vs plain versions at the DANet path's shapes
    model = pt.get_model(SEG_NAME, rng=0, device="cuda")
    _randomize_bn(model, seed=1)
    t0 = time.perf_counter()
    with _recording(_seg_targets()) as build_calls:
        serve = pt.make_serving_fn(SEG_NAME, SEG_SOURCE_HW,
                                   task="segmentation", device="cuda",
                                   model=model)
    torch.cuda.synchronize()
    print(f"danet serving fn built (calibrate + quantize): "
          f"{time.perf_counter() - t0:.3f} s")
    (a32, _, out32), = build_calls["flash_attention"]
    del build_calls
    raw = _raw_batch(SEG_BATCH_CHECK, seed=2, hw=SEG_SOURCE_HW)
    with _recording(_seg_targets()) as calls:
        serve(raw)
    torch.cuda.synchronize()
    max_err = {}
    with torch.inference_mode():
        _check_preprocess(calls["preprocess"], max_err, "danet", scaled=True)
        _check_stem(calls["stem"], max_err, "danet")
        _check_pool(calls["maxpool_i8"], max_err, "danet")
        _check_convs(calls["int8_conv"], max_err, "danet")
        _check_bend(calls["int8_conv"], max_err)
        (a, k, out), = calls["flash_attention"]
        errs = [_check_attention(*a[:3], out, "path"),
                _check_attention(*a32[:3], out32, "calibration")]
        # The random model's q.k logits saturate the softmax (one key a
        # row, checked exactly above); the path's q scaled to logits of
        # std ~2 makes every key count.
        q, kk, v = a[:3]
        s = 2.0 / (q.shape[-1] ** 0.5 * float(q.float().std())
                   * float(kk.float().std()))
        q = (q.float() * s).to(q.dtype)
        errs.append(_check_attention(q, kk, v, flash_attention(q, kk, v),
                                     "path, q scaled"))
        g = torch.Generator().manual_seed(4)
        for dtype in (torch.bfloat16, torch.float32):
            q, kk = (torch.randn((2, 3601, 64), generator=g).mul_(0.3)
                     .to(dtype).cuda() for _ in range(2))
            v = torch.randn((2, 3601, 512), generator=g).to(dtype).cuda()
            errs.append(_check_attention(q, kk, v, flash_attention(q, kk, v),
                                         "ragged L=3601"))
        max_err["flash_attention"] = max(errs)
    del calls, a32, out32
    torch.cuda.synchronize()

    # -- 6. the slice, with launch counts
    reset_launch_counts()
    maps = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"danet launches in one forward: {launches}")
    _require(launches == SEG_LAUNCHES, launches)
    _require(len(maps) == 3, f"{len(maps)} maps")
    for m in maps:
        _require(tuple(m.shape) == (SEG_BATCH_CHECK, 19, 480, 480), m.shape)
        _require(bool(torch.isfinite(m.float()).all()), "non-finite map")
    ref = serve.make_reference_forward()(raw)
    torch.cuda.synchronize()
    for i, (m, r) in enumerate(zip(maps, ref)):
        y, yf = m.float(), r.float()
        cos = float((y * yf).sum() / (y.norm() * yf.norm()))
        agree = float((y.argmax(1) == yf.argmax(1)).float().mean())
        print(f"danet map {i} int8 vs f32 reference: cosine {cos:.6f}, "
              f"argmax agreement {agree:.6f}")
        if i == 0:
            _require(cos >= 0.99, f"danet cosine {cos} < 0.99")
            _require(agree >= 0.97, f"danet argmax agreement {agree} < 0.97")
    del maps, ref

    # -- 7. timing at batch 8
    raw8 = _raw_batch(SEG_BATCH_TIME, seed=3, hw=SEG_SOURCE_HW)
    with torch.inference_mode():
        ms_serve = _cuda_ms(lambda: serve(raw8), reps=5, warmup=2)
        print(f"[{card}] serving {SEG_NAME} int8 batch {SEG_BATCH_TIME}: "
              f"{ms_serve:.3f} ms/batch, "
              f"{SEG_BATCH_TIME * 1000.0 / ms_serve:.2f} img/s")
        head_convs = []
        hooks = [mod.register_forward_pre_hook(
                     lambda m_, a_: head_convs.append((m_, a_[0])))
                 for mod in serve.head.modules()
                 if isinstance(mod, torch.nn.Conv2d)]
        with _recording(_seg_targets()) as calls8:
            serve(raw8)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        t = {}
        (a, k, out), = calls8["preprocess"]
        r, ct = a[1], a[2]
        x32 = a[0].permute(0, 3, 1, 2).float()
        t["preprocess"] = (
            _cuda_ms(lambda: preprocess(*a, **k), 20),
            _cuda_ms(lambda: preprocess_reference(*a, **k), 20),
            _cuda_ms(lambda: torch.einsum("oh,bchw,wp->bcop", r, x32, ct),
                     20), _work_preprocess(a, out))
        del x32
        (a, k, out), = calls8["stem"]
        xs = a[0].float()
        ws = a[1].permute(3, 0, 1, 2).float()
        t["stem"] = (
            _cuda_ms(lambda: stem_conv(*a, **k), 20),
            _cuda_ms(lambda: stem_conv_reference(*a, **k), 5),
            _cuda_ms(lambda: F.conv2d(xs, ws, stride=2, padding=1), 20),
            _work_stem(a, k, out))
        del xs
        (a, k, out), = calls8["maxpool_i8"]
        t["maxpool_i8"] = (
            _cuda_ms(lambda: maxpool_i8(*a, **k), 20),
            _cuda_ms(lambda: maxpool_i8_reference(*a, **k), 20), None,
            _work_pool(a, out))
        (a, k, out), = calls8["flash_attention"]
        qa, ka, va = a[:3]
        t["flash_attention"] = (
            _cuda_ms(lambda: flash_attention(*a, **k), 5),
            _cuda_ms(lambda: flash_attention_reference(*a, **k), 3),
            _cuda_ms(lambda: F.scaled_dot_product_attention(
                qa, ka, va, scale=1.0), 10),
            _work_attention(a, out))
        convs = [(a, k) for a, k, _ in calls8["int8_conv"]]
        conv_bound = _work_convs(calls8["int8_conv"])
        del calls8
        t["int8_conv"] = (
            _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs], 3),
            _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                              for a, k in convs], 1, warmup=1),
            None, conv_bound)
        del convs
        ms_head = _cuda_ms(lambda: [m_(x_) for m_, x_ in head_convs], 3)
        n_head = len(head_convs)
        del head_convs
    for name, (ms, plain, lib, bound) in t.items():
        what = "54 convs of one forward" if name == "int8_conv" else "one call"
        print(f"[{card}] danet {name} batch {SEG_BATCH_TIME} ({what}): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound[0]:.4f} ms ({bound[1]}), share of the batch "
              f"{100.0 * ms / ms_serve:.1f} %")
    rest = ms_serve - ms_head - sum(v[0] for v in t.values())
    print(f"[{card}] danet cuDNN bf16 head convs ({n_head} calls) batch "
          f"{SEG_BATCH_TIME}: {ms_head:.4f} ms, share "
          f"{100.0 * ms_head / ms_serve:.1f} %; the rest of the batch "
          f"(channel attention, upsampling, BN, host gaps): {rest:.4f} ms")
    replaces = {
        "preprocess": ("preprocess.cu",
                       "pytorchcv_tpu/kernels/preprocess.py:133"),
        "stem": ("stem.cu", "pytorchcv_tpu/quant/seg_backbone_int8.py:85"),
        "maxpool_i8": ("stem.cu", "pytorchcv_tpu/quant/resnet_int8.py:112"),
        "int8_conv": ("int8_conv.cu", "pytorchcv_tpu/quant/resnet_int8.py:66"),
        "flash_attention": ("flash_attention.cu",
                            "pytorchcv_tpu/kernels/flash_attention.py:110")}
    for name, (source, rep) in replaces.items():
        ms, plain, lib, bound = t[name]
        record.append(_record_entry(name, SEG_NAME, source, rep,
                                    launches[name], max_err[name], ms, plain,
                                    bound, lib))


def _rfc_video(seed: int):
    """A synthetic RFC_FRAMES-frame clip at RFC_HW on the card: forward and
    backward flows (T-1, 4, H, W), each component a sum of four
    low-frequency sinusoids drifting in time (|flow| <= 10 px), and masks
    (T, 1, H, W) of an ellipse covering ~10 % of the frame that moves
    across it."""
    g = torch.Generator().manual_seed(seed)
    (h, w), t = RFC_HW, RFC_FRAMES
    ys = torch.linspace(0.0, 1.0, h, device="cuda")[:, None]
    xs = torch.linspace(0.0, 1.0, w, device="cuda")[None, :]
    tt = torch.arange(t - 1, device="cuda", dtype=torch.float32)[:, None,
                                                                  None]
    comps = []
    for _ in range(4):
        field = torch.zeros(t - 1, h, w, device="cuda")
        for _ in range(4):
            fy, fx = torch.randint(0, 4, (2,), generator=g).tolist()
            amp, phase, drift = (torch.rand(3, generator=g)
                                 * torch.tensor([1.5, 6.2832, 0.1])).tolist()
            field += (amp + 1.0) * torch.sin(
                6.2832 * (fy * ys + fx * xs) + phase + drift * tt)
        comps.append(field)
    flows = torch.stack(comps, dim=1)
    ft = torch.arange(t, device="cuda", dtype=torch.float32)[:, None, None]
    cy = 0.5 + 0.25 * torch.cos(6.2832 * ft / t)
    cx = 0.5 + 0.3 * torch.sin(6.2832 * ft / t)
    inside = ((xs - cx) / 0.2) ** 2 + ((ys - cy) / 0.16) ** 2 <= 1.0
    return flows, inside.to(torch.float32)[:, None]


@contextlib.contextmanager
def _first_calls(mod, attr):
    """Count the calls of ``mod.attr`` and keep (args, kwargs, output) of
    its first call at each distinct input shape."""
    seen, count = {}, [0]
    orig = getattr(mod, attr)

    def rec(*a, **k):
        out = orig(*a, **k)
        count[0] += 1
        seen.setdefault(tuple(tuple(x.shape) for x in a[:3]) + (a[3],),
                        (a, k, out))
        return out
    setattr(mod, attr, rec)
    try:
        yield seen, count
    finally:
        setattr(mod, attr, orig)


def _deform_case(shape, groups, rb, dtype, seed):
    """K5 inputs at ``shape`` with offsets = center + U(-rb, rb), centers
    of std 6 (windows across the borders), masks U(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    _, c, h, w = shape
    x = torch.randn(shape, generator=g).to(dtype).cuda()
    center = torch.randn((1, 1, 1, 2, h, w), generator=g) * 6.0
    resid = (torch.rand((1, groups, 9, 2, h, w), generator=g) * 2 - 1) * rb
    offset = (center + resid).reshape(1, 18 * groups, h, w).cuda()
    mask = torch.rand((1, 9 * groups, h, w), generator=g).cuda()
    return x, offset, mask


def _check_deform(a, out, what) -> float:
    """K5 against its plain version: f32 within RFC_F32_TOL of max|x|, bf16
    within 1 bf16 ulp at the tensor's scale. Returns the max abs error."""
    from pytorchcv_tpu_torch.kernels.deform_patch import \
        deform_sample_reference
    from pytorchcv_tpu_torch.kernels.preprocess import bf16_ulp_error
    x, offset, mask, groups = a[:4]
    ref = deform_sample_reference(x, offset, mask, groups)
    err = float((out.float() - ref.float()).abs().max())
    if x.dtype == torch.bfloat16:
        ulp = float(bf16_ulp_error(out, ref).max())
        print(f"K5 {what} bf16 x {tuple(x.shape)} G {groups}: max {ulp} bf16 "
              f"ulp (scaled), max abs err {err}")
        _require(ulp <= 1, f"K5 {what} differs by {ulp} bf16 ulp")
    else:
        rel = err / float(x.abs().max())
        print(f"K5 {what} f32 x {tuple(x.shape)} G {groups}: max abs err "
              f"{err}, {rel:.3e} of max|x|")
        _require(rel <= RFC_F32_TOL, f"K5 {what} f32 error {rel} of max|x|")
    return err


def _work_deform(a, out):
    """Bytes: x, offsets, mask read once and the taps written once.
    Operations: 10 f32 a tap element (three lerps, the mask)."""
    return _bound(_nbytes(*a[:3], out), 10 * out.numel(), "f32")


def _device_kernels(fn, reps: int):
    """Device time a call of every kernel ``fn`` launches, by name (ms),
    from ``torch.profiler``'s CUDA activity after one warm-up call; empty
    when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def _rfc(card, record) -> None:
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.models.propainter_rfc as rfc_mod
    import pytorchcv_tpu_torch.nn.deform as deform_mod
    import torch.nn.functional as F
    from pytorchcv_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pytorchcv_tpu_torch.kernels.deform_patch import (
        deform_sample, deform_sample_reference)
    from pytorchcv_tpu_torch.models.propainter_rfc_stream import \
        ProPainterRFCSequencer

    # -- 8. the RFC slice through the streaming engine, with launch counts
    model = pt.get_model("propainter_rfc", rng=0, device="cuda")
    flows, masks = _rfc_video(seed=5)
    n_out = RFC_FRAMES - 1

    def stream():
        return ProPainterRFCSequencer(flows, masks, model,
                                      window_size=RFC_WINDOW,
                                      padding=RFC_PADDING)
    seq = stream()
    per_window = [4 * (m.sources[0].stop - m.sources[0].start - 1)
                  for m in seq.window_index]
    print(f"rfc windows (target:offset <- flows/masks): {seq.window_index}, "
          f"K5 launches per window {per_window}")
    torch.cuda.synchronize()
    with _first_calls(deform_mod, "deform_sample") as (seen, _):
        reset_launch_counts()
        comp = seq[0:n_out]
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    print(f"rfc launches over {RFC_FRAMES} frames: {launches}")
    _require(launches == {k: sum(per_window) if k == "deform_sample" else 0
                          for k in LAUNCHES}, launches)
    _require(tuple(comp.shape) == (n_out, 4, *RFC_HW), comp.shape)
    _require(bool(torch.isfinite(comp).all()), "non-finite completed flows")
    # combine_flows: outside the masks the input flows come back unchanged
    known = torch.cat([masks[:-1], masks[1:]], dim=1).repeat_interleave(
        2, dim=1) == 0
    _require(torch.equal(comp[known], flows[known]),
             "flows outside the masks changed")
    max_flow = float(comp.abs().max())
    print(f"rfc completed flows {tuple(comp.shape)}: finite, max |flow| "
          f"{max_flow:.4f} (input {float(flows.abs().max()):.4f}), "
          f"{float(masks.mean()):.4f} of pixels masked")
    torch.cuda.synchronize()

    # -- 9. K5 against its plain version
    errs = []
    with torch.inference_mode():
        for key, (a, k, out) in sorted(seen.items()):
            errs.append(_check_deform(a, out, "path"))
        fg_shape, fg_groups, fg_rb = RFC_FLOW_GUIDED
        for dtype in (torch.float32, torch.bfloat16):
            a = (*_deform_case(fg_shape, fg_groups, fg_rb, dtype, 6),
                 fg_groups, fg_rb)
            errs.append(_check_deform(a, deform_sample(*a),
                                      "flow-guided, centers std 6"))
    torch.cuda.synchronize()

    # -- 10. end to end: the same model with deform_conv2d routed to its
    # general formulation (no center), patched here and only here
    def general(*a, **k):
        k.pop("center", None)
        return deform_mod.deform_conv2d(*a, **k)
    rfc_mod.deform_conv2d = general
    try:
        reset_launch_counts()
        comp_general = stream()[0:n_out]
        torch.cuda.synchronize()
        _require(LAUNCHES["deform_sample"] == 0, "general route launched K5")
    finally:
        rfc_mod.deform_conv2d = deform_mod.deform_conv2d
    delta = float((comp - comp_general).abs().max())
    print(f"rfc K5 vs the general route: max |delta| {delta} = "
          f"{delta / max_flow:.3e} of max |flow| (gate {RFC_E2E_TOL})")
    _require(delta <= RFC_E2E_TOL * max_flow,
             f"rfc end to end delta {delta} > {RFC_E2E_TOL} * {max_flow}")
    del comp_general
    # the card against the CPU (the plain sampler, CPU convs) on the clip's
    # first RFC_SHORT flows, before the random recurrence has grown
    fm = torch.cat([masks[:-1], masks[1:]], dim=1)[:RFC_SHORT]
    with torch.inference_mode():
        card_f, _ = rfc_mod.calc_bidirectional_opt_flow_completion_by_pprfc(
            model, flows[:RFC_SHORT], fm)
        cpu_f, _ = rfc_mod.calc_bidirectional_opt_flow_completion_by_pprfc(
            copy.deepcopy(model).cpu(), flows[:RFC_SHORT].cpu(), fm.cpu())
    rel = float((card_f.cpu() - cpu_f).abs().max() / cpu_f.abs().max())
    print(f"rfc card vs CPU on {RFC_SHORT} flows: max |delta| {rel:.3e} of "
          f"max |flow| {float(cpu_f.abs().max()):.4f} (gate {RFC_CPU_TOL})")
    _require(rel <= RFC_CPU_TOL, f"rfc card vs CPU: {rel} of max |flow|")

    # -- 11. timing: one pass over the clip after the passes above
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    seq = stream()
    first_stop = seq.window_index[0].target.stop
    ev[0].record()
    seq[0:first_stop]
    ev[1].record()
    seq[first_stop:n_out]
    ev[2].record()
    torch.cuda.synchronize()
    win_ms = [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])]
    ms_pass = sum(win_ms)
    print(f"[{card}] rfc {RFC_FRAMES} frames at {RFC_HW[0]}x{RFC_HW[1]}, "
          f"window {RFC_WINDOW}, padding {RFC_PADDING} (f32, no TF32): "
          f"{ms_pass:.3f} ms, {n_out * 1000.0 / ms_pass:.2f} completed-flow "
          f"frames/s; windows {win_ms[0]:.3f} and {win_ms[1]:.3f} ms")
    (key, (a, k, out)), = seen.items()
    x, offset, mask, groups = a[:4]
    with torch.inference_mode():
        ms = _cuda_ms(lambda: deform_sample(*a, **k), 50)
        plain = _cuda_ms(lambda: deform_sample_reference(*a[:4]), 20)
        # library yardstick: grid_sample over x as (G, C/G, H, W) at the
        # same (y, x) positions (align_corners=True, zeros), times the mask
        from pytorchcv_tpu_torch.kernels.deform_patch import tap_positions
        _, c, h, w = x.shape
        py, px, m = tap_positions(offset, mask, groups, (3, 3), 1, 1,
                                  x.dtype)
        grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1],
                           dim=-1)[0].permute(2, 0, 1, 3).contiguous()
        xg = x.view(groups, c // groups, h, w)
        mg = m[0].permute(2, 0, 1)[:, None]
        lib = _cuda_ms(lambda: F.grid_sample(
            xg, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True) * mg, 50)
        lib_err = float((F.grid_sample(xg, grid, align_corners=True) * mg
                         - out.view(h * w, 9, groups, c // groups)
                         .permute(2, 3, 0, 1)).abs().max())
        bound = _work_deform(a, out)
        # the 3-D encoder and every 2-D conv of one RFC call (one direction
        # of the first window), replayed
        t_w = seq.window_index[0].sources[0]
        f1 = flows[t_w.start:t_w.stop, :2][None]
        m1 = masks[t_w.start:t_w.stop][None]
        ms_call = _cuda_ms(lambda: model(f1, m1), 3, warmup=1)
        convs = []
        hooks = [mod.register_forward_pre_hook(
                     lambda m_, a_: convs.append((m_, a_[0])))
                 for mod in model.modules()
                 if type(mod) in (torch.nn.Conv2d, torch.nn.Conv3d)]
        model(f1, m1)
        for hk in hooks:
            hk.remove()
        conv3 = [c_ for c_ in convs if isinstance(c_[0], torch.nn.Conv3d)]
        conv2 = [c_ for c_ in convs if not isinstance(c_[0], torch.nn.Conv3d)]
        prop = {id(m_) for m_ in
                model.hg.skip_seq.skip4.feat_prop_module.modules()}
        conv2r = [c_ for c_ in conv2 if id(c_[0]) in prop]
        conv2d = [c_ for c_ in conv2 if id(c_[0]) not in prop]
        ms3 = _cuda_ms(lambda: [m_(x_) for m_, x_ in conv3], 3, warmup=1)
        ms2r = _cuda_ms(lambda: [m_(x_) for m_, x_ in conv2r], 3, warmup=1)
        ms2d = _cuda_ms(lambda: [m_(x_) for m_, x_ in conv2d], 3, warmup=1)
        n_conv = (len(conv3), len(conv2r), len(conv2d))
        del convs, conv3, conv2, conv2r, conv2d
        # device time (profiler): K5's kernel alone, and every kernel of
        # one RFC call against its wall time
        k5_dev = [v for n_, v in _device_kernels(
            lambda: deform_sample(*a, **k), 20).items()
            if "deform_sample" in n_]
        call_dev = _device_kernels(lambda: model(f1, m1), 1)
    n_k5 = per_window[0] // 2
    print(f"[{card}] rfc K5 at x {tuple(x.shape)} G {groups}: wrapper "
          f"{ms:.4f} ms a call (CUDA events, back to back; the kernel alone "
          f"on the device: "
          f"{f'{sum(k5_dev):.4f} ms' if k5_dev else 'not measured'}, "
          f"profiler), plain {plain:.4f} ms, "
          f"grid_sample x mask {lib:.4f} ms (max |diff| to K5 "
          f"{lib_err:.2e}), bound {bound[0]:.4f} ms ({bound[1]}); per "
          f"window {per_window[0]} x {ms:.4f} = {per_window[0] * ms:.3f} ms")
    print(f"[{card}] rfc one call (T = {t_w.stop - t_w.start}, one "
          f"direction): {ms_call:.3f} ms; replayed alone: 3-D convs "
          f"({n_conv[0]}) {ms3:.3f} ms ({100.0 * ms3 / ms_call:.1f} %), "
          f"2-D convs of the propagation ({n_conv[1]}) {ms2r:.3f} ms "
          f"({100.0 * ms2r / ms_call:.1f} %), other 2-D convs "
          f"({n_conv[2]}) {ms2d:.3f} ms ({100.0 * ms2d / ms_call:.1f} %), "
          f"K5 {n_k5} x {ms:.4f} = {n_k5 * ms:.3f} ms "
          f"({100.0 * n_k5 * ms / ms_call:.1f} %)")
    if call_dev:
        busy = sum(call_dev.values())
        top = sorted(call_dev.items(), key=lambda kv: -kv[1])[:6]
        print(f"[{card}] rfc one call on the device (profiler): kernels busy "
              f"{busy:.3f} ms of {ms_call:.3f} ms wall, idle share "
              f"{100.0 * (1 - busy / ms_call):.1f} %; largest: " + "; ".join(
                  f"{n_[:60]} {v:.3f} ms" for n_, v in top))
    else:
        print(f"[{card}] rfc device busy and idle share: not measured (the "
              f"profiler saw no device activity)")
    record.append(_record_entry(
        "deform_sample", "propainter_rfc", "deform_sample.cu",
        "pytorchcv_tpu/kernels/deform_patch.py:81",
        launches["deform_sample"], max(errs), ms, plain, bound, lib))


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script runs only on a CUDA card")
    from pytorchcv_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device and build
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    torch.cuda.synchronize()
    print(f"[{card}] kernel build and load: "
          f"{time.perf_counter() - t0:.3f} s")

    record = []
    t0 = time.perf_counter()
    _resnet(card, record)
    print(f"resnet50 phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _danet(card, record)
    print(f"danet phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _rfc(card, record)
    print(f"rfc phases: {time.perf_counter() - t0:.1f} s")

    print(f"card: {card}")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
