"""K2 timed under every tile, on the int8 conv shapes of ResNet-50,
WRN-50-2 (224x224) and DANet (480x480), and the grouped K2 under every
grouped tile on the grouped convs of ResNeXt-50, SE-ResNeXt-50 and
SENet-16:

    python -m pytorchcv_tpu_torch.kernels.int8_conv_plans [batch [seg_batch]]
    python -m pytorchcv_tpu_torch.kernels.int8_conv_plans grouped [batch [senet_batch]]

Needs one CUDA card and nvcc. For each distinct conv of each path at
``batch`` (default 128; DANet at ``seg_batch``, default 8) it draws int8
operands (numpy seed 0), times one K2 launch with CUDA events over 10
launches after 2 under each tile of ``int8_conv.TILES``, and prints beside
each the plan's cost and which tile the plan picks, then per path the sum
over a forward's convs under the plan's tiles and under each shape's
fastest. Then K3 (the stem) at ResNet's 7x7 and DANet's 3x3 under several
output rows a tile, beside cuDNN's f32 conv of the same image. The last
line is one JSON object with the times in ms.

The grouped sweep (batch default 128, SENet-16 at ``senet_batch``,
default 32) prints per distinct grouped conv and tile the device ms
(``torch.profiler`` over 10 launches after 1, the mean of the launches it
recorded: ``_parts.launch_ms``; CUDA events beside it),
useful TOP/s, issued tensor-core TOP/s
(the zeros of the block-diagonal tiles and of the k32 padding included),
the plan's cost and which tile the plan picks, then per path the sum over
a forward under the plan's tiles and under each shape's fastest.

:func:`conv_shapes` and :func:`gconv_shapes` list the convs each path gives
K2 and the grouped K2 (the CPU tests read them too).
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


# (k, stride, cin, cout, groups, h, w) of one grouped K2 call; h, w the
# input map.
GConv = Tuple[int, int, int, int, int, int, int]


def gconv_shapes(name: str) -> List[GConv]:
    """The grouped convs of one forward of ``name`` ("resnext50_32x4d",
    "seresnext50_32x4d" or "senet16") at 224x224, in order: each unit's
    grouped 3x3 (32 groups; the stride at the first unit of stages 2-4),
    cg = og (ResNeXt, SE-ResNeXt: 128-1024 channels) or og = 2 cg (SENet-16:
    its conv1 halves the width)."""
    units = (1, 1, 1, 1) if name == "senet16" else (3, 4, 6, 3)
    half = name == "senet16"
    convs: List[GConv] = []
    hw = 56
    for si, n in enumerate(units):
        gw = 128 << si
        for uj in range(n):
            st = 2 if si > 0 and uj == 0 else 1
            convs.append((3, st, gw // 2 if half else gw, gw, 32, hw, hw))
            hw //= st
    return convs


def _grouped_sweep(name_card: str, rng, times: dict) -> None:
    """Every grouped tile at every grouped conv of the three paths, by
    device time."""
    from . import int8_conv as k2
    from ._build import f32
    from ._parts import launch_ms
    bsz = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    se_bsz = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    for path in ("resnext50_32x4d", "seresnext50_32x4d", "senet16"):
        b = se_bsz if path == "senet16" else bsz
        convs = gconv_shapes(path)
        fwd_plan = fwd_best = 0.0
        for conv in sorted(set(convs)):
            k, st, cin, cout, groups, h, w = conv
            ho, wo = out_hw((k, st, 1, cin, cout, h, w, False))
            x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin),
                                              dtype=np.int8)).cuda()
            wt = torch.from_numpy(rng.integers(
                -127, 128, (cout, k, k, cin // groups), dtype=np.int8)).cuda()
            a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(
                np.float32)).cuda()
            bb = torch.from_numpy(rng.standard_normal(cout).astype(
                np.float32)).cuda()
            args = (b, h, w, cin, cout, groups, k, st, 1)
            pick = k2.gconv_plan(*args)
            useful = 2 * b * ho * wo * cout * k * k * cin // groups
            tile_ms = {}
            for tile in k2.GCONV_TILES:
                p = k2.gconv_tile(*args, *tile)
                if p is None:
                    continue
                with torch.inference_mode():
                    ms, _, wall = launch_ms(lambda: k2._launch_grouped(
                        x, wt, a, bb, st, "relu", f32(0.7), None, None,
                        k2._RES_NONE, 1, False, groups, k2._OUT_I8, tile),
                        "int8_gconv_kernel")
                if ms is None:
                    raise RuntimeError("the profiler recorded no grouped K2")
                issued = k2.gconv_issued_ops(*args, p)
                key = (f"{path} k{k} s{st} {cin}->{cout} g{groups} {h}x{w} "
                       f"{tile[0]}x{tile[1]}")
                times[key] = tile_ms[tile] = ms
                print(f"[{name_card}] grouped K2 batch {b} {key} (u {p.u}, "
                      f"{p.imgs}x{p.th}x{p.tw} a tile, {p.ch} k32 chunks, "
                      f"{p.smem} shared bytes): {ms:.4f} ms on the device "
                      f"({wall:.4f} back to back), "
                      f"{useful / ms / 1e9:.1f} useful TOP/s, "
                      f"{issued / ms / 1e9:.1f} issued TOP/s, model cost "
                      f"{k2.gconv_cost(*args, p):.0f}"
                      f"{'  <- plan' if p == pick else ''}")
            n = convs.count(conv)
            fwd_plan += n * tile_ms[(pick.bm, pick.bn)]
            fwd_best += n * min(tile_ms.values())
        print(f"[{name_card}] grouped K2 batch {b} {path}: the {len(convs)} "
              f"grouped convs of a forward, {fwd_plan:.4f} ms under the "
              f"plan's tiles, {fwd_best:.4f} ms under each shape's fastest")


def main() -> None:
    from . import int8_conv as k2
    from ._build import f32
    from ._parts import card, cuda_ms
    if not torch.cuda.is_available():
        raise RuntimeError("int8_conv_plans needs a CUDA card")
    name_card = card()
    rng = np.random.default_rng(0)
    times = {}
    if len(sys.argv) > 1 and sys.argv[1] == "grouped":
        _grouped_sweep(name_card, rng, times)
        print(json.dumps({"card": name_card, "ms": times}))
        return
    bsz = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    seg_bsz = int(sys.argv[2]) if len(sys.argv) > 2 else 8
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
                args = (x, wt, a, bb, st, None if res else "relu",
                        f32(0.7), r, f32(0.01) if res else None,
                        k2._RES_I8 if res else k2._RES_NONE, dil, False,
                        k2._OUT_I8, tile)
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
