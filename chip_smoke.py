#!/usr/bin/env python3
"""GPU smoke test of pytorchcv_tpu_torch: int8 ResNet-50 serving on the
port's hand-written CUDA kernels.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the kernels from ``csrc/`` at first
use. Phases, each ending in ``torch.cuda.synchronize()``:

1. device and build: the card (nvidia-smi name and power limit), torch and
   CUDA versions, the kernel build time;
2. kernels vs their plain PyTorch versions, on the inputs one batch-32
   ResNet-50 forward (256x256 frames, crop 224) gives them: preprocess
   (K1) within 1 bf16 ulp, every distinct int8 conv (K2) bit-exact, the
   stem (K3) with at most 0.1 % of elements off by 1;
3. the slice: ``make_serving_fn("resnet50", (256, 256), device="cuda")`` on
   seeded random weights (BN statistics randomized by an explicit
   generator); one batch with launch counts K1 = 1, K3 = 1, K2 = 52,
   finite (B, 1000) logits, cosine >= 0.99 against the f32 reference
   forward (no TF32);
4. timing with CUDA events at batch 128: serving images/s, and each
   kernel beside its plain version at the shapes of that batch.

Any failure raises. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch

BATCH_CHECK = 32
BATCH_TIME = 128
SOURCE_HW = (256, 256)
STEM_TOLERANCE = 1e-3          # share of int8 elements allowed off by 1


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
    statistics would hide a per-channel fault in the folding."""
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


def _raw_batch(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *SOURCE_HW, 3), generator=g,
                         dtype=torch.uint8).cuda()


@contextlib.contextmanager
def _recording():
    """Record every kernel-wrapper call (args, kwargs, output) the serving
    path makes, by name."""
    import pytorchcv_tpu_torch.kernels.preprocess as pre_mod
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    calls = {"preprocess": [], "int8_conv": [], "stem": []}
    targets = [(pre_mod, "preprocess", "preprocess"),
               (rq, "int8_conv", "int8_conv"),
               (rq, "stem_conv_pool", "stem")]
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


def _conv_key(a, k):
    x, w = a[0], a[1]
    res = k.get("residual")
    mode = ("int8" if k["q"] is not None else "bf16",
            "relu" if k["relu"] else "linear",
            "no-res" if res is None else
            f"res-{str(res.dtype)[6:]}{'-bf16round' if k.get('round_res') else ''}")
    return (w.shape[1], k["stride"], x.shape[3], w.shape[0], x.shape[1],
            "/".join(mode))


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script runs only on a CUDA card")
    import pytorchcv_tpu_torch as pt
    from pytorchcv_tpu_torch.kernels import (LAUNCHES, _build,
                                             reset_launch_counts)
    from pytorchcv_tpu_torch.kernels.int8_conv import (int8_conv,
                                                       int8_conv_reference)
    from pytorchcv_tpu_torch.kernels.preprocess import (bf16_ulp_distance,
                                                        preprocess,
                                                        preprocess_reference)
    from pytorchcv_tpu_torch.kernels.stem import (stem_conv_pool,
                                                  stem_conv_pool_reference)

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
    with _recording() as calls:
        serve(raw)
    torch.cuda.synchronize()
    max_err = {}
    with torch.inference_mode():
        (a, k, out), = calls["preprocess"]
        ref = preprocess_reference(*a, **k)
        ulp = int(bf16_ulp_distance(out, ref).max())
        max_err["preprocess"] = float((out.float() - ref.float()).abs().max())
        print(f"K1 preprocess {tuple(a[0].shape)} -> {tuple(out.shape)} "
              f"{out.dtype}: max {ulp} bf16 ulp, max abs err "
              f"{max_err['preprocess']}")
        _require(ulp <= 1, f"K1 differs by {ulp} bf16 ulp")

        (a, k, out), = calls["stem"]
        ref = stem_conv_pool_reference(*a, **k)
        diff = (out.int() - ref.int()).abs()
        share = float((diff != 0).float().mean())
        max_err["stem"] = float(diff.max())
        print(f"K3 stem {tuple(a[0].shape)} -> {tuple(out.shape)}: "
              f"{share:.6f} of elements differ, max diff {max_err['stem']}")
        _require(max_err["stem"] <= 1 and share <= STEM_TOLERANCE,
                 f"K3 off by {max_err['stem']} on a share {share}")

        seen = {}
        for a, k, out in calls["int8_conv"]:
            seen.setdefault(_conv_key(a, k), (a, k, out))
        max_err["int8_conv"] = 0.0
        for key, (a, k, out) in sorted(seen.items()):
            ref = int8_conv_reference(*a, **k)
            err = float((out.float() - ref.float()).abs().max())
            max_err["int8_conv"] = max(max_err["int8_conv"], err)
            print(f"K2 k={key[0]} s={key[1]} cin={key[2]} cout={key[3]} "
                  f"h={key[4]} {key[5]}: "
                  f"{'bit-exact' if torch.equal(out, ref) else 'DIFFERS'}")
            _require(torch.equal(out, ref), f"K2 not bit-exact at {key}")
        print(f"K2: {len(seen)} distinct convs of "
              f"{len(calls['int8_conv'])} bit-exact")
    del calls
    torch.cuda.synchronize()

    # -- 3. the slice, with launch counts
    reset_launch_counts()
    logits = serve(raw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"launches in one forward: {launches}")
    _require(launches == {"preprocess": 1, "stem": 1, "int8_conv": 52},
             launches)
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
        with _recording() as calls128:
            serve(raw128)
        torch.cuda.synchronize()
        timings = {}
        (a, k, _), = calls128["preprocess"]
        timings["preprocess"] = (
            _cuda_ms(lambda: preprocess(*a, **k), 20),
            _cuda_ms(lambda: preprocess_reference(*a, **k), 20))
        (a, k, _), = calls128["stem"]
        timings["stem"] = (
            _cuda_ms(lambda: stem_conv_pool(*a, **k), 20),
            _cuda_ms(lambda: stem_conv_pool_reference(*a, **k), 5))
        convs = [(a, k) for a, k, _ in calls128["int8_conv"]]
        del calls128
        timings["int8_conv"] = (
            _cuda_ms(lambda: [int8_conv(*a, **k) for a, k in convs], 5),
            _cuda_ms(lambda: [int8_conv_reference(*a, **k)
                              for a, k in convs], 2, warmup=1))
    for name, (ms, plain) in timings.items():
        what = "52 convs of one forward" if name == "int8_conv" else "one call"
        print(f"[{card}] {name} batch {BATCH_TIME} ({what}): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms")

    src = "pytorchcv_tpu_torch/csrc/"
    record = {"kernels": [
        {"name": "preprocess", "route": "cuda", "source": src + "preprocess.cu",
         "replaces": "pytorchcv_tpu/kernels/preprocess.py:106"},
        {"name": "int8_conv", "route": "cuda", "source": src + "int8_conv.cu",
         "replaces": "pytorchcv_tpu/quant/resnet_int8.py:66"},
        {"name": "stem", "route": "cuda", "source": src + "stem.cu",
         "replaces": "pytorchcv_tpu/quant/resnet_int8.py:252"}]}
    for entry in record["kernels"]:
        name = entry["name"]
        entry.update(launches=launches[name], max_abs_err=max_err[name],
                     ms=timings[name][0], plain_ms=timings[name][1])
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
