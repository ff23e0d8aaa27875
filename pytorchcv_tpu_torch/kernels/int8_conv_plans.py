"""K2 timed under every tile, on the int8 conv shapes of ResNet-50,
WRN-50-2 (224x224) and DANet (480x480):

    python -m pytorchcv_tpu_torch.kernels.int8_conv_plans [batch [seg_batch]]

Needs one CUDA card and nvcc. For each distinct conv of each path at
``batch`` (default 128; DANet at ``seg_batch``, default 8) it draws int8
operands (numpy seed 0), times one K2 launch with CUDA events over 10
launches after 2 under each tile of ``int8_conv.TILES``, and prints beside
each the plan's cost and which tile the plan picks, then per path the sum
over a forward's convs under the plan's tiles and under each shape's
fastest. Then K3 (the stem) at ResNet's 7x7 and DANet's 3x3 under several
output rows a tile, beside cuDNN's f32 conv of the same image. The last
line is one JSON object with the times in ms.

:func:`conv_shapes` lists the convs each path gives K2 (the CPU tests read
it too).
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (k, stride, dilation, cin, cout, h, w, residual) of one K2 call; h, w the
# input map.
Conv = Tuple[int, int, int, int, int, int, int, bool]


def _resnet_convs(width: int) -> List[Conv]:
    """The 19 K2 convs of the int8 ResNet route (stem at 224): each stage's
    first unit (identity conv, conv1, conv2, conv3 with the residual; the
    stride at conv1 in ResNet-50, at conv2 in WRN-50-2) and stage 4's last
    unit, the bf16-output tail; ``width`` 1 for ResNet-50, 2 for WRN-50-2
    (the mid widths doubled)."""
    convs: List[Conv] = []
    cin, hw = 64, 56
    for si, (mid, out) in enumerate(((64, 256), (128, 512), (256, 1024),
                                     (512, 2048))):
        mid *= width
        st = 1 if si == 0 else 2
        ho = hw // st
        s1, s2 = (st, 1) if width == 1 else (1, st)
        h2 = hw // s1
        convs += [(1, st, 1, cin, out, hw, hw, False),
                  (1, s1, 1, cin, mid, hw, hw, False),
                  (3, s2, 1, mid, mid, h2, h2, False),
                  (1, 1, 1, mid, out, ho, ho, True)]
        cin, hw = out, ho
    mid = 512 * width
    return convs + [(1, 1, 1, 2048, mid, 7, 7, False),
                    (3, 1, 1, mid, mid, 7, 7, False),
                    (1, 1, 1, mid, 2048, 7, 7, True)]


def _danet_convs() -> List[Conv]:
    """The 54 K2 convs of DANet's dilated ResNet-D50b backbone at 480x480:
    the deep stem's conv2 and conv3, then per unit (identity conv in the
    first) conv1, conv2 (stage 2's first strided; dilation 2 in stage 3
    past its first unit and in stage 4's first, 4 after) and conv3 with
    the residual."""
    convs: List[Conv] = [(3, 1, 1, 64, 64, 240, 240, False),
                         (3, 1, 1, 64, 128, 240, 240, False)]
    cin, hw = 128, 120
    for si, (n, mid, out) in enumerate(((3, 64, 256), (4, 128, 512),
                                        (6, 256, 1024), (3, 512, 2048)), 1):
        for uj in range(1, n + 1):
            st = 2 if si == 2 and uj == 1 else 1
            dil = 2 ** max(0, si - 2 - int(uj == 1))
            ho = hw // st
            if uj == 1:
                convs.append((1, st, 1, cin, out, hw, hw, False))
            convs += [(1, 1, 1, cin, mid, hw, hw, False),
                      (3, st, dil, mid, mid, hw, hw, False),
                      (1, 1, 1, mid, out, ho, ho, True)]
            cin, hw = out, ho
    return convs


def conv_shapes(name: str) -> List[Conv]:
    """The K2 convs of one forward of ``name`` ("resnet50", "wrn50_2" or
    "danet"), in order."""
    return {"resnet50": lambda: _resnet_convs(1),
            "wrn50_2": lambda: _resnet_convs(2),
            "danet": _danet_convs}[name]()


def out_hw(conv: Conv) -> Tuple[int, int]:
    k, st, dil, _, _, h, w, _ = conv
    pad = dil * (k // 2)
    return ((h + 2 * pad - dil * (k - 1) - 1) // st + 1,
            (w + 2 * pad - dil * (k - 1) - 1) // st + 1)


def main() -> None:
    from . import int8_conv as k2
    from ._build import f32
    from ._parts import card, cuda_ms
    if not torch.cuda.is_available():
        raise RuntimeError("int8_conv_plans needs a CUDA card")
    bsz = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    seg_bsz = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    name_card = card()
    rng = np.random.default_rng(0)
    times = {}
    for path, b in (("resnet50", bsz), ("wrn50_2", bsz), ("danet", seg_bsz)):
        convs = conv_shapes(path)
        fwd_plan = fwd_best = 0.0
        for conv in sorted(set(convs)):
            k, st, dil, cin, cout, h, w, res = conv
            ho, wo = out_hw(conv)
            x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin),
                                              dtype=np.int8)).cuda()
            wt = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin),
                                               dtype=np.int8)).cuda()
            a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(
                np.float32)).cuda()
            bb = torch.from_numpy(rng.standard_normal(cout).astype(
                np.float32)).cuda()
            r = torch.from_numpy(rng.integers(-127, 128, (b, ho, wo, cout),
                                              dtype=np.int8)).cuda() \
                if res else None
            m = b * ho * wo
            pick = k2.plan(m, cout, cin, k)
            tile_ms = {}
            for tile in k2.TILES:
                args = (x, wt, a, bb, st, not res, f32(0.7), r,
                        f32(0.01) if res else None,
                        k2._RES_I8 if res else k2._RES_NONE, dil, False, tile)
                with torch.inference_mode():
                    ms = cuda_ms(lambda: k2._launch(*args))
                key = (f"{path} k{k} s{st} d{dil} {cin}->{cout} {h}x{w}"
                       f"{' res' if res else ''} {tile[0]}x{tile[1]}")
                times[key] = tile_ms[tile] = ms
                tops = 2 * m * cout * k * k * cin / ms / 1e9
                print(f"[{name_card}] K2 batch {b} {key}: {ms:.4f} ms, "
                      f"{tops:.1f} TOP/s, model cost "
                      f"{k2.plan_cost(m, cout, cin, k, *tile):.0f}"
                      f"{'  <- plan' if tile == pick else ''}")
            n = convs.count(conv)
            fwd_plan += n * tile_ms[pick]
            fwd_best += n * min(tile_ms.values())
        print(f"[{name_card}] K2 batch {b} {path}: the {len(convs)} convs "
              f"of a forward, one launch each, {fwd_plan:.4f} ms under the "
              f"plan's tiles, {fwd_best:.4f} ms under each shape's fastest")
    # K3 at the two stems under several rows a tile, beside cuDNN's f32
    # conv of the same image (no bias, ReLU or quantization).
    from . import stem as k3
    for tag, b, hw, k in (("resnet stem 7x7", bsz, 224, 7),
                          ("danet stem 3x3", seg_bsz, 480, 3)):
        x = torch.from_numpy(rng.standard_normal((b, 3, hw, hw)).astype(
            np.float32)).cuda().to(torch.bfloat16)
        kf = torch.from_numpy((rng.standard_normal((3, k, k, 64)) * 0.1)
                              .astype(np.float32)).cuda().to(torch.bfloat16)
        bias = torch.from_numpy(rng.standard_normal(64).astype(
            np.float32)).cuda()
        pick = k3.stem_plan(b, hw, hw, k)
        for rows in sorted({1, 2, 4, 8, 16, pick}):
            if k3.stem_smem(k, rows, hw) > k3._SMEM_ONE:
                continue
            with torch.inference_mode():
                ms = cuda_ms(lambda: k3._launch(x, kf, bias, 40.0, rows))
            times[f"{tag} batch {b} rows {rows}"] = ms
            print(f"[{name_card}] K3 {tag} batch {b}, {rows} rows a tile: "
                  f"{ms:.4f} ms{'  <- plan' if rows == pick else ''}")
        xf, wf = x.float(), kf.permute(3, 0, 1, 2).float()
        ms = cuda_ms(lambda: F.conv2d(xf, wf, stride=2, padding=k // 2))
        times[f"{tag} batch {b} cuDNN f32"] = ms
        print(f"[{name_card}] {tag} batch {b}: cuDNN f32 conv {ms:.4f} ms")
    print(json.dumps({"card": name_card, "batch": bsz, "seg_batch": seg_bsz,
                      "ms": times}))


if __name__ == "__main__":
    main()
