#!/usr/bin/env python3
"""Where the int8 segmentation route loses per-pixel argmax agreement with
the f32 model: the witness beside ``chip_smoke.py``'s phase 32.

    python3 chip_seg_agreement.py

Needs one CUDA card and nvcc (the kernels build from ``csrc/`` at first
use, as for ``chip_smoke.py``, whose helpers it imports). For ``pspnet``, ``deeplabv3`` and ``fcn8sd_resnetd101b_voc`` (aux,
21 classes, 480x480 from 375x500 frames), on the first weight draws that
phase 32 tries (``get_model(rng=w)``, BN from seed ``w + 1``), w in 0, 1,
2, whether or not their f32 maps are decisive enough for phase 32 to
take them (``chip_smoke.SEG_DECISIVE``), and on
two kinds of batch-2 frames, uniform uint8 noise (``_raw_batch``, seed 2,
phase 32's) and a seeded texture (``_texture_batch``: uint8 noise at a
quarter of the size, upsampled, as ``_pipe_clip``'s frames), it prints for
the int8 route (mode auto) and the bf16 route against the f32 reference:
cosine, argmax agreement on every pixel, and agreement by the f32 map's
top-2 margin (share of pixels and agreement in each bin of margin / max
|logit|). On draw 0 of each model it also prints:

* the trunk's error: cosine of the int8 route's stage-4 and bend outputs,
  and of the bf16 copy's, against the f32 backbone's;
* the f32 head on the int8 features: the agreement that is left when the
  head runs in f32, so the head's bf16 rounding is not in it;
* FCN-8s(d) only, the int8 route on the CPU (the kernels' plain versions,
  with the card's calibrated scales; K1 and K3 differ from their plain
  versions by an ulp or an off-by-one, so the trunks part from the
  card's and meet only in their statistics): its agreement with the
  CPU's f32 model and with the card's int8 maps.

The last line is a JSON object of every figure printed.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as cs

MARGIN_BINS = (0.0, 0.01, 0.02, 0.05, 0.1, float("inf"))
WEIGHT_SEEDS = (0, 1, 2)


def _texture_batch(n: int, seed: int, hw) -> torch.Tensor:
    """uint8 noise at a quarter of ``hw``, bilinearly upsampled: frames
    with spatial structure, from a seed."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    h, w = hw
    small = torch.randint(0, 256, (n, 3, (h + 3) // 4, (w + 3) // 4),
                          generator=g).to(torch.float32)
    big = F.interpolate(small, (h, w), mode="bilinear", align_corners=False)
    return big.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous().cuda()


def _margin_table(y, yf):
    """[(lo, hi, share of pixels, agreement)] by the f32 map's top-2 class
    margin over its largest |logit|."""
    same = y.float().argmax(1) == yf.float().argmax(1)
    top2 = yf.float().topk(2, dim=1).values
    rel = (top2[:, 0] - top2[:, 1]) / yf.float().abs().amax(dim=1)
    rows = []
    for lo, hi in zip(MARGIN_BINS[:-1], MARGIN_BINS[1:]):
        sel = (rel >= lo) & (rel < hi)
        rows.append((lo, hi, float(sel.float().mean()),
                     float(same[sel].float().mean()) if bool(sel.any())
                     else None))
    return rows


def _cosine(y, yf) -> float:
    y, yf = y.double(), yf.double()
    return float((y * yf).sum() / (y.norm() * yf.norm()))


def _summary(y, yf) -> dict:
    every, decisive, share = cs._agreement(y, yf)
    return dict(cosine=_cosine(y, yf), every=every, decisive=decisive,
                decisive_share=share, bins=_margin_table(y, yf),
                max_abs_logit=float(yf.float().abs().max()))


def _show(tag: str, s: dict) -> None:
    bins = ", ".join(
        f"[{lo:g}, {hi:g}) {100 * sh:.1f} % "
        + ("-" if a is None else f"{a:.4f}")
        for lo, hi, sh, a in s["bins"])
    print(f"{tag}: cosine {s['cosine']:.6f}, agreement {s['every']:.6f} "
          f"on every pixel, {s['decisive']:.6f} on the "
          f"{100 * s['decisive_share']:.1f} % decisive; by margin: {bins}")


def _features(model, serve, raw):
    """(int8 route's features, bf16 copy's, f32 backbone's), each (stage 4,
    bend) in NCHW f32, and the int8 features through the f32 head."""
    from pytorchcv_tpu_torch.kernels._build import no_tf32
    from pytorchcv_tpu_torch.kernels.preprocess import segmentation_preprocess
    from pytorchcv_tpu_torch.quant.seg_backbone_int8 import (
        prepare_int8_seg_backbone)
    from pytorchcv_tpu_torch.serve import as_bfloat16
    hw = tuple(raw.shape[1:3])
    pre = segmentation_preprocess(tuple(model.in_size), hw, layout="nchw",
                                  device="cuda")
    pre32 = segmentation_preprocess(tuple(model.in_size), hw, layout="nchw",
                                    device="cuda", out_dtype=torch.float32)
    run, plan = prepare_int8_seg_backbone(model, serve.scales)
    with torch.inference_mode(), no_tf32():
        q = tuple(t.permute(0, 3, 1, 2).float() for t in run(plan, pre(raw)))
        f = tuple(t.float() for t in model.backbone(pre32(raw)))
        bf = as_bfloat16(model)
        b = tuple(t.float() for t in bf.backbone(pre(raw)))
        head32 = model(q, from_features=True)
    return q, b, f, head32


def _cpu_route(model, serve, raw):
    """The int8 route on the CPU (the kernels' plain versions) with the
    card's scales: (int8 maps, f32 maps)."""
    import copy
    from pytorchcv_tpu_torch.kernels._build import no_tf32
    from pytorchcv_tpu_torch.kernels.preprocess import segmentation_preprocess
    from pytorchcv_tpu_torch.quant.seg_backbone_int8 import (
        prepare_int8_seg_backbone)
    from pytorchcv_tpu_torch.serve import as_bfloat16
    cpu = copy.deepcopy(model).cpu()
    raw = raw.cpu()
    hw = tuple(raw.shape[1:3])
    pre = segmentation_preprocess(tuple(cpu.in_size), hw, layout="nchw",
                                  device="cpu")
    pre32 = segmentation_preprocess(tuple(cpu.in_size), hw, layout="nchw",
                                    device="cpu", out_dtype=torch.float32)
    run, plan = prepare_int8_seg_backbone(cpu, serve.scales)
    head = as_bfloat16(cpu, without=cpu.backbone)
    with torch.inference_mode(), no_tf32():
        feats = tuple(t.permute(0, 3, 1, 2) for t in run(plan, pre(raw)))
        maps = head(feats, from_features=True)
        ref = cpu(pre32(raw))
    return maps, ref


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_seg_agreement: no CUDA card")
    import pytorchcv_tpu_torch as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs._card()
    print(f"card: {card}")
    torch.set_num_threads(8)
    hw = cs.DENSE_SEG_SOURCE_HW
    frames = {"noise": cs._raw_batch(cs.SEG_BATCH_CHECK, seed=2, hw=hw),
              "texture": _texture_batch(cs.SEG_BATCH_CHECK, seed=2, hw=hw)}
    out = {}
    for name in cs.DENSE_SEG:
        for w in WEIGHT_SEEDS:
            model = cs._dense_model(name, w)
            serve = pt.make_serving_fn(name, hw, task="segmentation",
                                       device="cuda", model=model)
            serve_bf = pt.make_serving_fn(name, hw, mode="bf16",
                                          task="segmentation", device="cuda",
                                          model=model)
            ref_fn = serve.make_reference_forward()
            for kind, raw in frames.items():
                ref = ref_fn(raw)
                for route, fn in (("int8", serve), ("bf16", serve_bf)):
                    maps = fn(raw)
                    for what, m, r in zip(("main", "aux"), maps, ref):
                        s = _summary(m, r)
                        key = f"{name} w{w} {kind} {route} {what}"
                        _show(f"[{card}] {key}", s)
                        out[key] = s
                if w != 0:
                    continue
                q, b, f, head32 = _features(model, serve, raw)
                for what, qi, bi, fi in zip(("stage 4", "bend"), q, b, f):
                    key = f"{name} w0 {kind} trunk {what}"
                    out[key] = dict(int8=_cosine(qi, fi),
                                    bf16=_cosine(bi, fi))
                    print(f"[{card}] {key} vs the f32 backbone: cosine int8 "
                          f"{out[key]['int8']:.6f}, bf16 "
                          f"{out[key]['bf16']:.6f}")
                for what, m, r in zip(("main", "aux"), head32, ref):
                    s = _summary(m, r)
                    key = f"{name} w0 {kind} int8 features, f32 head {what}"
                    _show(f"[{card}] {key}", s)
                    out[key] = s
                if name.startswith("fcn8sd"):
                    t0 = time.perf_counter()
                    maps_cpu, ref_cpu = _cpu_route(model, serve, raw)
                    maps = serve(raw)
                    for what, mc, rc, m in zip(("main", "aux"), maps_cpu,
                                               ref_cpu, maps):
                        s = _summary(mc, rc)
                        s["argmax_equal_to_card"] = float(
                            (mc.float().argmax(1) == m.float().cpu()
                             .argmax(1)).float().mean())
                        s["max_abs_diff_to_card"] = float(
                            (mc.float() - m.float().cpu()).abs().max())
                        key = f"{name} w0 {kind} int8 on the CPU {what}"
                        _show(f"{key}", s)
                        print(f"{key}: argmax equal to the card's on "
                              f"{s['argmax_equal_to_card']:.6f} of the "
                              f"pixels, max |diff| "
                              f"{s['max_abs_diff_to_card']:.4f} "
                              f"({time.perf_counter() - t0:.1f} s)")
                        out[key] = s
            del model, serve, serve_bf
            torch.cuda.empty_cache()
        sys.stdout.flush()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
