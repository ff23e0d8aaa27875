"""K8 timed under every plan that fits, on the stride-1 chain shapes of
ResNet-50 and WRN-50-2 at 224x224:

    python -m pytorchcv_tpu_torch.kernels.fused_bottleneck_plans [batch]

Needs one CUDA card and nvcc. For each shape (H, W, C, M) at ``batch``
(default 128) it draws one unit's operands (numpy seed 0), times one K8
launch with CUDA events over 10 launches after 2 under each tile of whole
rows (``ceil(H / n)`` rows) whose shared memory fits, and prints beside
each the cost that :func:`fused_bottleneck.plan` gives it and which one
the plan picks. The last line is one JSON object with the times in ms.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import fused_bottleneck as fb
from ._parts import card, cuda_ms

SHAPES = {"resnet50": [(56, 56, 256, 64), (28, 28, 512, 128),
                       (14, 14, 1024, 256), (7, 7, 2048, 512)],
          "wrn50_2": [(56, 56, 256, 128), (28, 28, 512, 256),
                      (14, 14, 1024, 512), (7, 7, 2048, 1024)]}


def _unit(rng, bsz, h, w, c, m, dev):
    def cell(cout, k, cin):
        return {"wq": torch.from_numpy(rng.integers(
                    -127, 128, (cout, k, k, cin), dtype=np.int8)).to(dev),
                "gain": torch.from_numpy((rng.uniform(0.5, 1.5, cout) / (
                    127.0 * np.sqrt(k * k * cin))).astype(np.float32)).to(dev),
                "bias": torch.from_numpy((rng.standard_normal(cout) * 0.1)
                                         .astype(np.float32)).to(dev)}
    unit = {"conv1": cell(m, 1, c), "conv2": cell(m, 3, m),
            "conv3": cell(c, 1, m)}
    x = torch.from_numpy(rng.integers(-127, 128, (bsz, h, w, c),
                                      dtype=np.int8)).to(dev)
    return x, fb.pack_units([unit], [2.0, 1.5, 1.8, 2.2])


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("fused_bottleneck_plans needs a CUDA card")
    bsz = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    name_card = card()
    rng = np.random.default_rng(0)
    times = {}
    for name, shapes in SHAPES.items():
        for h, w, c, m in shapes:
            x, packed = _unit(rng, bsz, h, w, c, m, "cuda")
            pick = fb.plan(bsz, h, w, c, m)
            for th in fb._splits(h):
                if fb._smem(th, w, m) > fb._SMEM_ONE:
                    continue
                with torch.inference_mode():
                    ms = cuda_ms(lambda: fb._launch(x, packed, (th, w)))
                key = f"{name} {h}x{w} C{c} M{m} th{th}"
                times[key] = ms
                print(f"[{name_card}] K8 batch {bsz} {key}: {ms:.4f} ms, "
                      f"smem {fb._smem(th, w, m)}, model cost "
                      f"{fb._plan_cost(bsz, h, w, c, m, th, w):.4g}"
                      f"{'  <- plan' if (th, w) == pick else ''}")
    print(json.dumps({"card": name_card, "batch": bsz, "ms": times}))


if __name__ == "__main__":
    main()
