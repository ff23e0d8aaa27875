"""Two trees of the port on one card, in turns: K2 (the int8 convs of one
forward), K3 (the stem) and serving throughput of int8 resnet50 and
wrn50_2 at batch 128 and int8 DANet at batch 8:

    python3 pytorchcv_tpu_torch/kernels/compare_trees.py TREE_A TREE_B

Each TREE is the root of a checkout of the repository (for example the
parent commit's ``git archive`` unpacked into a git-ignored directory, and
``.``). The trees run in the order A, B, B, A, each in a process of its own
that imports ``pytorchcv_tpu_torch`` from that tree and builds its kernels
there, so the two versions share the card, its clocks and its neighbours.
Needs one CUDA card and nvcc. Weights are random from seed 0 (timing
only); inputs are seeded uint8 frames. Prints one line per measurement
and, last, one JSON object with every run's numbers in ms.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

SEG = "danet_resnetd50b_cityscapes"


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


def _measure(tree: str) -> dict:
    """One tree's numbers (run in its own process)."""
    sys.path.insert(0, tree)
    import torch
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.quant.resnet_int8 as rq
    import pytorchcv_tpu_torch.quant.seg_backbone_int8 as sq
    from pytorchcv_tpu_torch.kernels import _build
    if not Path(pt.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {pt.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    _build.library()
    out = {"build_s": time.perf_counter() - t0}
    g = torch.Generator().manual_seed(3)
    for name, hw, bsz, task, stem_mod in (
            ("resnet50", (256, 256), 128, "classification", rq),
            ("wrn50_2", (256, 256), 128, "classification", rq),
            (SEG, (1024, 2048), 8, "segmentation", sq)):
        model = pt.get_model(name, rng=0, device="cuda")
        serve = pt.make_serving_fn(name, hw, task=task, device="cuda",
                                   model=model)
        raw = torch.randint(0, 256, (bsz, *hw, 3), generator=g,
                            dtype=torch.uint8).cuda()
        calls = {"int8_conv": [], "stem_conv": []}
        saved = []
        for mod, attr in ((rq, "int8_conv"), (stem_mod, "stem_conv")):
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
            ms = _cuda_ms(torch, lambda: serve(raw), 10 if bsz > 8 else 5,
                          warmup=3)
        key = "danet" if name == SEG else name
        out[key] = {"serve_ms": ms, "per_s": bsz * 1000.0 / ms,
                    "k2_ms": k2, "k2_calls": len(convs), "k3_ms": k3}
        del model, serve, raw, calls, convs
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(_measure(sys.argv[2])))
        return
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    trees = {"A": sys.argv[1], "B": sys.argv[2]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    for label in "ABBA":
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--measure", trees[label]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"tree {label} ({trees[label]}) failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"tree": label, "root": trees[label], **res})
        for path in ("resnet50", "wrn50_2", "danet"):
            r = res[path]
            print(f"[{card}] {label} ({trees[label]}) {path}: serving "
                  f"{r['serve_ms']:.3f} ms = {r['per_s']:.1f} /s, K2 "
                  f"({r['k2_calls']} calls) {r['k2_ms']:.4f} ms, K3 "
                  f"{r['k3_ms']:.4f} ms")
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
