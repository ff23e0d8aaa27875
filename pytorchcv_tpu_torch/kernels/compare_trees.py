"""Two trees of the port on one card, in turns: K2 (the int8 convs of one
forward), K3 (the stem), ``maxpool_i8`` and serving throughput of int8
resnet50 and wrn50_2 at batch 128 and int8 DANet at batch 8; int8
resnext50_32x4d serving at batch 128 and senet16 at batch 32 with their
16 and 4 grouped K2 convs timed four ways (on the device in the forward;
replayed back to back; conv by conv launched again and again, and after
a write that evicts L2); bf16
efficientnet_b0 serving at batch 128 and K6 (its 16 depthwise calls of
one forward, back to back); ProPainter RFC's
completed-flow frames/s over a 160-frame 240x432 clip and K5 a call at
its shape; the generator chain's (IP -> IT -> IM) frames/s over an
80-frame clip and K5 at its first call's shape; K9 (the int8 7x7 stem) at
batch 128; int8 mobilenetv2_w1 and mobilenet_w1 serving at batch 128 and
K12 (their 17 and 13 int8 depthwise convs of one forward, back to back
through the wrappers and on the device as a CUDA graph's replay):

    python3 pytorchcv_tpu_torch/kernels/compare_trees.py TREE_A TREE_B [PATH ...]

Each TREE is the root of a checkout of the repository (for example the
parent commit's ``git archive`` unpacked into a git-ignored directory, and
``.``). PATHs pick what to measure, of ``resnet50``, ``wrn50_2``,
``danet``, ``resnext50_32x4d``, ``senet16``, ``efficientnet_b0``,
``rfc``, ``propainter``, ``stem_int8``, ``mobilenetv2_w1`` and
``mobilenet_w1`` (default: all). The
trees run in the order A, B, B, A, each in a process of its own that
imports ``pytorchcv_tpu_torch`` from that tree and builds its kernels
there, so the two versions share the card, its clocks and its neighbours;
the video clips and models come from this checkout's ``chip_smoke.py``.
Needs one CUDA card and nvcc. Weights are random from seed 0 (timing
only); inputs are seeded. Prints one line per measurement and, last, one
JSON object with every run's numbers in ms.
"""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

SEG = "danet_resnetd50b_cityscapes"
PATHS = ("resnet50", "wrn50_2", "danet", "resnext50_32x4d", "senet16",
         "efficientnet_b0", "rfc", "propainter", "stem_int8",
         "mobilenetv2_w1", "mobilenet_w1")
GROUPED = {"resnext50_32x4d": 128, "senet16": 32}   # path: batch
MOBILENETS = ("mobilenetv2_w1", "mobilenet_w1")
_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def _cuda_ms(torch, fn, reps, warmup=2):
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


def _first_k5_call(torch, fn):
    """Run ``fn`` with ``nn.deform.deform_sample`` recording its first
    call's arguments; returns (fn's result, those arguments)."""
    import pytorchcv_tpu_torch.nn.deform as deform_mod
    orig, seen = deform_mod.deform_sample, []

    def rec(*a, **k):
        if not seen:
            seen.append((a, k))
        return orig(*a, **k)
    deform_mod.deform_sample = rec
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        deform_mod.deform_sample = orig
    return res, seen[0]


def _video(torch, smoke, out: dict, paths) -> None:
    """RFC's and the generator's frames/s over chip_smoke's clips (one
    untimed pass, then one timed), and K5 back to back at each path's
    first call."""
    import pytorchcv_tpu_torch as pt
    from pytorchcv_tpu_torch.kernels.deform_patch import deform_sample
    if "rfc" in paths:
        from pytorchcv_tpu_torch.models.propainter_rfc_stream import \
            ProPainterRFCSequencer
        model = pt.get_model("propainter_rfc", rng=0, device="cuda")
        flows, masks = smoke._rfc_video(seed=5)
        n_out = smoke.RFC_FRAMES - 1

        def run():
            return ProPainterRFCSequencer(
                flows, masks, model, window_size=smoke.RFC_WINDOW,
                padding=smoke.RFC_PADDING)[0:n_out]
        with torch.inference_mode():
            _, (a, k) = _first_k5_call(torch, run)
            ms = _cuda_ms(torch, run, 1, warmup=0)
            k5 = _cuda_ms(torch, lambda: deform_sample(*a, **k), 50)
        out["rfc"] = {"clip_ms": ms, "per_s": n_out * 1000.0 / ms,
                      "k5_ms": k5}
        del model, flows, masks
    if "propainter" in paths:
        model = pt.get_model("propainter", rng=0, device="cuda")
        smoke._tame_propainter(model)
        frames, masks, flows = smoke._pp_clip(seed=5)

        def run():
            return smoke._pp_chain(model, frames, masks, flows)[2][
                0:smoke.PP_FRAMES]
        with torch.inference_mode():
            _, (a, k) = _first_k5_call(torch, run)
            ms = _cuda_ms(torch, run, 1, warmup=0)
            k5 = _cuda_ms(torch, lambda: deform_sample(*a, **k), 50)
        out["propainter"] = {"clip_ms": ms,
                             "per_s": smoke.PP_FRAMES * 1000.0 / ms,
                             "k5_ms": k5}
        del model, frames, masks, flows
    torch.cuda.empty_cache()


def _stem_int8(torch, out: dict) -> None:
    """K9 back to back at batch 128, 224x224, O 64, on seeded inputs."""
    from pytorchcv_tpu_torch.kernels.stem_conv import stem_conv7x7_s2
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((128, 224, 224, 3), generator=g) * 2 - 1).cuda()
    k7 = (torch.randn((7, 7, 3, 64), generator=g) * 0.1).cuda()
    gain = (torch.rand(64, generator=g) + 0.5).cuda()
    bias = (torch.randn(64, generator=g) * 0.1).cuda()
    with torch.inference_mode():
        ms = _cuda_ms(torch, lambda: stem_conv7x7_s2(x, k7, gain, bias, 1.0,
                                                     4.0), 20)
    out["stem_int8"] = {"k9_ms": ms}


def _kernel_ms(torch, fn, name, launches, reps=10):
    """Device ms a call of ``fn``, which launches kernels whose name holds
    ``name`` ``launches`` times: the mean over the launches
    ``torch.profiler`` recorded (it may record fewer than ran) times
    ``launches``, after one warm-up call; profiled again where it recorded
    none, up to 3 times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if name in e.key]
        n = sum(e.count for e in seen)
        if n:
            return sum(e.self_device_time_total for e in seen) / 1e3 / n * \
                launches
    raise RuntimeError(f"the profiler saw no {name} on the device")


def _grouped(torch, pt, rq, out: dict, path: str) -> None:
    """int8 serving of ``path`` at its batch of ``GROUPED`` (256x256
    frames) and its grouped K2 calls four ways: on the device in the
    forward, replayed back to back (CUDA events and device time), conv by
    conv (each distinct conv launched 10 times, times its count) with the
    input and weights the launch before left in L2, and after a 256 MB
    write that evicts L2."""
    name, bsz = "int8_gconv_kernel", GROUPED[path]
    model = pt.get_model(path, rng=0, device="cuda")
    serve = pt.make_serving_fn(path, (256, 256), device="cuda", model=model)
    g = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (bsz, 256, 256, 3), generator=g,
                        dtype=torch.uint8).cuda()
    calls, orig = [], rq.int8_conv

    def rec(*a, **k):
        if k.get("groups", 1) > 1:
            calls.append((a, k))
        return orig(*a, **k)
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    with torch.inference_mode():
        rq.int8_conv = rec
        try:
            serve(raw)
        finally:
            rq.int8_conv = orig
        torch.cuda.synchronize()
        ms = _cuda_ms(torch, lambda: serve(raw), 10, warmup=3)
        fwd = _kernel_ms(torch, lambda: serve(raw), name, len(calls), 3)
        seq = _cuda_ms(torch, lambda: [orig(*a, **k) for a, k in calls], 10)
        seq_dev = _kernel_ms(torch, lambda: [orig(*a, **k)
                                             for a, k in calls], name,
                             len(calls), 3)
        distinct = {}
        for a, k in calls:
            key = (tuple(a[0].shape), tuple(a[1].shape), k["stride"])
            distinct.setdefault(key, [a, k, 0])[2] += 1
        hot = cold = 0.0
        for a, k, n in distinct.values():
            hot += n * _kernel_ms(torch, lambda: orig(*a, **k), name, 1)
            cold += n * _kernel_ms(torch, lambda: (flush.fill_(1),
                                                   orig(*a, **k)), name, 1)
    out[path] = {
        "serve_ms": ms, "per_s": bsz * 1000.0 / ms, "gconv_calls": len(calls),
        "gconv_fwd_ms": fwd, "gconv_seq_ms": seq, "gconv_seq_dev_ms": seq_dev,
        "gconv_hot_ms": hot, "gconv_flushed_ms": cold}
    del model, serve, raw, calls, flush
    torch.cuda.empty_cache()


def _effnet(torch, pt, out: dict) -> None:
    """bf16 efficientnet_b0 serving at batch 128 (256x256 frames) and its
    16 K6 calls of one forward, back to back."""
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    model = pt.get_model("efficientnet_b0", rng=0, device="cuda")
    serve = pt.make_serving_fn("efficientnet_b0", (256, 256), device="cuda",
                               model=model)
    g = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (128, 256, 256, 3), generator=g,
                        dtype=torch.uint8).cuda()
    calls, orig = [], conv_mod.dwconv2d_bn_act

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    with torch.inference_mode():
        conv_mod.dwconv2d_bn_act = rec
        try:
            serve(raw)
        finally:
            conv_mod.dwconv2d_bn_act = orig
        torch.cuda.synchronize()
        k6 = _cuda_ms(torch, lambda: [orig(*a, **k) for a, k in calls], 20)
        ms = _cuda_ms(torch, lambda: serve(raw), 10, warmup=3)
    out["efficientnet_b0"] = {"serve_ms": ms, "per_s": 128 * 1000.0 / ms,
                              "k6_ms": k6, "k6_calls": len(calls)}


def _mobilenet(torch, pt, out: dict, path: str) -> None:
    """int8 ``path`` serving at batch 128 (256x256 frames) and its K12
    calls of one forward, replayed back to back (CUDA events and device
    time)."""
    import pytorchcv_tpu_torch.quant.mobilenet_int8 as mq
    model = pt.get_model(path, rng=0, device="cuda")
    serve = pt.make_serving_fn(path, (256, 256), device="cuda", model=model)
    g = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (128, 256, 256, 3), generator=g,
                        dtype=torch.uint8).cuda()
    calls, orig = [], mq.dwconv_i8

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    with torch.inference_mode():
        mq.dwconv_i8 = rec
        try:
            serve(raw)
        finally:
            mq.dwconv_i8 = orig
        torch.cuda.synchronize()

        def k12():
            for a, k in calls:
                orig(*a, **k)
        k12_ms = _cuda_ms(torch, k12, 20)
        # on the device: the calls captured in a CUDA graph and replayed
        # (through the wrappers, back to back, they time the host)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            k12()
        k12_dev = _cuda_ms(torch, graph.replay, 20)
        del graph
        ms = _cuda_ms(torch, lambda: serve(raw), 10, warmup=3)
    out[path] = {"serve_ms": ms, "per_s": 128 * 1000.0 / ms,
                 "k12_ms": k12_ms, "k12_dev_ms": k12_dev,
                 "k12_calls": len(calls)}
    del model, serve, raw, calls
    torch.cuda.empty_cache()


def _measure(tree: str, paths) -> dict:
    """One tree's numbers (run in its own process)."""
    sys.path.insert(0, tree)
    import torch
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    import pytorchcv_tpu_torch.quant.seg_backbone_int8 as sq
    from pytorchcv_tpu_torch.kernels import _build
    if not Path(pt.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {pt.__file__}, not the tree {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke_clips", _SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    out = {"build_s": time.perf_counter() - t0}
    _video(torch, smoke, out, paths)
    if "stem_int8" in paths:
        _stem_int8(torch, out)
    if "efficientnet_b0" in paths:
        _effnet(torch, pt, out)
    for path in GROUPED:
        if path in paths:
            _grouped(torch, pt, rq, out, path)
    for path in MOBILENETS:
        if path in paths:
            _mobilenet(torch, pt, out, path)
    g = torch.Generator().manual_seed(3)
    for name, hw, bsz, task, stem_mod in (
            ("resnet50", (256, 256), 128, "classification", rq),
            ("wrn50_2", (256, 256), 128, "classification", rq),
            (SEG, (1024, 2048), 8, "segmentation", sq)):
        key = "danet" if name == SEG else name
        if key not in paths:
            continue
        model = pt.get_model(name, rng=0, device="cuda")
        serve = pt.make_serving_fn(name, hw, task=task, device="cuda",
                                   model=model)
        raw = torch.randint(0, 256, (bsz, *hw, 3), generator=g,
                            dtype=torch.uint8).cuda()
        calls = {"int8_conv": [], "stem_conv": [], "maxpool_i8": []}
        saved = []
        for mod, attr in ((rq, "int8_conv"), (stem_mod, "stem_conv"),
                          (stem_mod, "maxpool_i8")):
            orig = getattr(mod, attr)
            saved.append((mod, attr, orig))

            def rec(*a, _orig=orig, _attr=attr, **k):
                calls[_attr].append((a, k))
                return _orig(*a, **k)
            setattr(mod, attr, rec)
        with torch.inference_mode():
            serve(raw)
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)
            torch.cuda.synchronize()
            convs = calls["int8_conv"]
            (sa, sk), = calls["stem_conv"]
            k2 = _cuda_ms(torch, lambda: [rq.int8_conv(*a, **k)
                                          for a, k in convs], 5)
            k3 = _cuda_ms(torch, lambda: stem_mod.stem_conv(*sa, **sk), 20)
            (pa, pk), = calls["maxpool_i8"]
            pool = _cuda_ms(torch, lambda: stem_mod.maxpool_i8(*pa, **pk), 20)
            ms = _cuda_ms(torch, lambda: serve(raw), 10 if bsz > 8 else 5,
                          warmup=3)
        out[key] = {"serve_ms": ms, "per_s": bsz * 1000.0 / ms,
                    "k2_ms": k2, "k2_calls": len(convs), "k3_ms": k3,
                    "pool_ms": pool}
        del model, serve, raw, calls, convs, pa, pk
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        print(json.dumps(_measure(sys.argv[2], sys.argv[3:])))
        return
    paths = sys.argv[3:] or list(PATHS)
    if len(sys.argv) < 3 or not set(paths) <= set(PATHS):
        raise SystemExit(__doc__)
    trees = {"A": sys.argv[1], "B": sys.argv[2]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    for label in "ABBA":
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--measure", trees[label], *paths],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"tree {label} ({trees[label]}) failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"tree": label, "root": trees[label], **res})
        for path in ("resnet50", "wrn50_2", "danet"):
            if path in res:
                r = res[path]
                print(f"[{card}] {label} ({trees[label]}) {path}: serving "
                      f"{r['serve_ms']:.3f} ms = {r['per_s']:.1f} /s, K2 "
                      f"({r['k2_calls']} calls) {r['k2_ms']:.4f} ms, K3 "
                      f"{r['k3_ms']:.4f} ms, maxpool_i8 {r['pool_ms']:.4f} "
                      f"ms")
        for path in GROUPED:
            if path not in res:
                continue
            r = res[path]
            print(f"[{card}] {label} ({trees[label]}) {path}: "
                  f"serving {r['serve_ms']:.3f} ms = {r['per_s']:.1f} /s; "
                  f"grouped K2 ({r['gconv_calls']} calls) "
                  f"{r['gconv_fwd_ms']:.4f} ms on the device in the forward, "
                  f"{r['gconv_seq_dev_ms']:.4f} on the device back to back "
                  f"({r['gconv_seq_ms']:.4f} by CUDA events), conv by conv "
                  f"{r['gconv_hot_ms']:.4f} launched again and again, "
                  f"{r['gconv_flushed_ms']:.4f} after an L2 flush")
        for path in MOBILENETS:
            if path in res:
                r = res[path]
                print(f"[{card}] {label} ({trees[label]}) {path} int8: "
                      f"serving {r['serve_ms']:.3f} ms = {r['per_s']:.1f} "
                      f"/s, K12 ({r['k12_calls']} calls) {r['k12_ms']:.4f} "
                      f"ms back to back, {r['k12_dev_ms']:.4f} ms on the "
                      f"device (a CUDA graph)")
        if "efficientnet_b0" in res:
            r = res["efficientnet_b0"]
            print(f"[{card}] {label} ({trees[label]}) efficientnet_b0: "
                  f"serving {r['serve_ms']:.3f} ms = {r['per_s']:.1f} /s, K6 "
                  f"({r['k6_calls']} calls) {r['k6_ms']:.4f} ms")
        for path in ("rfc", "propainter"):
            if path in res:
                r = res[path]
                print(f"[{card}] {label} ({trees[label]}) {path}: clip "
                      f"{r['clip_ms']:.3f} ms = {r['per_s']:.3f} frames/s, "
                      f"K5 {r['k5_ms']:.4f} ms a call")
        if "stem_int8" in res:
            print(f"[{card}] {label} ({trees[label]}) K9 batch 128: "
                  f"{res['stem_int8']['k9_ms']:.4f} ms")
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
