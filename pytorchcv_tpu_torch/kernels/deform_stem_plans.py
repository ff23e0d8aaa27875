"""K5 (deformable sampling) and K9 (the int8 7x7 stem) timed under their
plans' alternatives on the card:

    python -m pytorchcv_tpu_torch.kernels.deform_stem_plans [--host]

Needs one CUDA card and nvcc. K5 at ProPainter RFC's call (x (1, 256, 30,
54), G 16, bound 5) and the generator's (x (1, 128, 60, 108), G 16, bound
3), f32 and bf16: for x NCHW (the launch transposes it) and channels-last,
the wrapper back to back (CUDA events) and the kernel alone on the device
(``torch.profiler``) under 1, 2, 4 and 8 pixels a tile (the cooperative
launch of an NCHW x may widen them), beside ``F.grid_sample``
times the mask, and RFC's ``torch.cat`` of the two feature maps into NCHW
and into channels-last. K9 at batch 128, 224x224 under several output rows
a tile, beside cuDNN's f32 conv of the image. Inputs are seeded; times are
ms a call. First, K5's host path at RFC's call split into its parts (host
microseconds a call; ``--host``: only that). The last line is one JSON
object with every time.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from . import deform_patch as k5
from . import stem_conv as k9


def _cuda_ms(fn, reps=50, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _device_ms(fn, name, reps=20):
    """Device time a call of the kernels whose name holds ``name``
    (``torch.profiler``), None if the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    t = [e.self_device_time_total for e in prof.key_averages()
         if name in e.key and e.self_device_time_total > 0]
    return sum(t) / 1e3 / reps if t else None


def _deform_case(shape, groups, rb, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    _, c, h, w = shape
    x = torch.randn(shape, generator=g).to(dtype).cuda()
    center = torch.randn((1, 1, 1, 2, h, w), generator=g) * 6.0
    resid = (torch.rand((1, groups, 9, 2, h, w), generator=g) * 2 - 1) * rb
    offset = (center + resid).reshape(1, 18 * groups, h, w).cuda()
    mask = torch.rand((1, 9 * groups, h, w), generator=g).to(dtype).cuda()
    return x, offset, mask


def _grid_sample(x, offset, mask, groups):
    _, c, h, w = x.shape
    py, px, m = k5.tap_positions(offset, mask, groups, (3, 3), 1, 1, x.dtype)
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1],
                       dim=-1)[0].permute(2, 0, 1, 3).contiguous().to(x.dtype)
    xg = x.view(groups, c // groups, h, w)
    mg = m[0].permute(2, 0, 1)[:, None].to(x.dtype)
    return lambda: F.grid_sample(xg, grid, mode="bilinear",
                                 padding_mode="zeros",
                                 align_corners=True) * mg


def _host_us(fn, reps=2000):
    """Host microseconds a call of ``fn`` (nothing synchronized inside
    the loop: the card runs behind)."""
    import time
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _host_split(card, times):
    """Where K5's wrapper spends host time at RFC's f32 call, NCHW x: the
    whole call, its checks, the output allocation, and the bare launch
    (``library().pcv_deform_sample`` with fixed pointers)."""
    from ._build import library, stream_of
    x, off, m = _deform_case((1, 256, 30, 54), 16, 5.0, torch.float32, 6)
    lib, st = library(), stream_of(x)
    h, w, c = 30, 54, 256
    out = torch.empty(h * w * 10 * c, device="cuda")
    args = (x.data_ptr(), out.data_ptr() + h * w * 9 * c * 4,
            off.data_ptr(), m.data_ptr(), out.data_ptr(), h, w, c, 16, 0, 4,
            4, 0, st)
    args_cl = (x.data_ptr(), 0, off.data_ptr(), m.data_ptr(),
               out.data_ptr(), h, w, c, 16, 0, 4, 4, 1, st)
    n = (h * w - (-h * w // 9)) * 9 * c
    parts = {
        "wrapper": lambda: k5.deform_sample(x, off, m, 16, 5.0),
        "_launch": lambda: k5._launch(x, off, m, 16, False, 4),
        "bare launch, cooperative": lambda: lib.pcv_deform_sample(*args),
        "bare launch, channels-last instance": (
            lambda: lib.pcv_deform_sample(*args_cl)),
        "torch.empty": lambda: torch.empty(n, device="cuda"),
        "torch.empty + slice": lambda: torch.empty(
            (n // (9 * c), 9, c), device="cuda")[:h * w],
        "stream_of": lambda: stream_of(x),
        "grid_sample x mask": _grid_sample(x, off, m, 16),
    }
    for name, fn in parts.items():
        us = _host_us(fn)
        times[f"host {name}"] = us
        print(f"[{card}] K5 host path, RFC f32 NCHW: {name} {us:.2f} us a "
              f"call")


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    times = {}
    with torch.inference_mode():
        _host_split(card, times)
        if "--host" in sys.argv:
            print(json.dumps({"card": card, "ms": times}))
            return
        for tag, shape, rb in (("rfc", (1, 256, 30, 54), 5.0),
                               ("generator", (1, 128, 60, 108), 3.0)):
            for dtype in (torch.float32, torch.bfloat16):
                x, off, m = _deform_case(shape, 16, rb, dtype, 6)
                lib = _cuda_ms(_grid_sample(x, off, m, 16))
                dt = "f32" if dtype == torch.float32 else "bf16"
                times[f"{tag} {dt} grid_sample x mask"] = lib
                print(f"[{card}] K5 {tag} {dt} x {shape}: grid_sample x mask "
                      f"{lib:.4f} ms")
                plan = k5.deform_plan(shape[2], shape[3], 16)
                for layout in ("nchw", "channels_last"):
                    xl = x if layout == "nchw" else x.contiguous(
                        memory_format=torch.channels_last)
                    nhwc = layout != "nchw"
                    ms = _cuda_ms(lambda: k5.deform_sample(xl, off, m, 16,
                                                           rb))
                    dev = _device_ms(lambda: k5.deform_sample(xl, off, m, 16,
                                                              rb),
                                     "deform_sample")
                    times[f"{tag} {dt} {layout} wrapper"] = ms
                    times[f"{tag} {dt} {layout} device"] = dev
                    print(f"[{card}] K5 {tag} {dt} {layout}: wrapper {ms:.4f}"
                          f" ms back to back, device "
                          f"{'not measured' if dev is None else f'{dev:.4f}'}"
                          f" (plan: {plan} pixels a tile)")
                    for npix in (1, 2, 4, 8):
                        dev = _device_ms(lambda: k5._launch(
                            xl, off, m, 16, nhwc, npix), "deform_sample")
                        times[f"{tag} {dt} {layout} npix {npix}"] = dev
                        print(f"[{card}] K5 {tag} {dt} {layout}, {npix} "
                              f"pixels a tile: device "
                              f"{'not measured' if dev is None else f'{dev:.4f}'}"
                              f" ms{'  <- plan' if npix == plan else ''}")
        # RFC's x is the cat of two (1, 128, 30, 54) maps
        a, b = (torch.randn(1, 128, 30, 54, device="cuda") for _ in range(2))
        times["rfc cat nchw"] = _cuda_ms(lambda: torch.cat([a, b], 1))
        times["rfc cat channels_last"] = _cuda_ms(lambda: torch.cat(
            [a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)], 3))
        print(f"[{card}] RFC's cat of x: NCHW {times['rfc cat nchw']:.4f} ms,"
              f" channels-last {times['rfc cat channels_last']:.4f} ms")

    # K9's operands outside inference mode: prepared() caches on them
    g = torch.Generator().manual_seed(0)
    bsz = 128
    x = torch.rand((bsz, 224, 224, 3), generator=g).cuda() * 2 - 1
    k7 = torch.randn((7, 7, 3, 64), generator=g).cuda() * 0.1
    gain = torch.rand(64, generator=g).cuda() + 0.5
    bias = torch.randn(64, generator=g).cuda() * 0.1
    with torch.inference_mode():
        wq, gq = k9.prepared(k7, gain, 1.0)
        xn = x.permute(0, 3, 1, 2).contiguous()
        wf = k7.permute(3, 2, 0, 1).contiguous()
        lib = _cuda_ms(lambda: F.conv2d(xn, wf, stride=2, padding=3), 20)
        times["k9 cudnn f32"] = lib
        plan = k9.stem_int8_plan(bsz, 224, 224)
        ref = k9.stem_conv7x7_s2_reference(x, k7, gain, bias, 1.0, 4.0)
        ms = _cuda_ms(lambda: k9.stem_conv7x7_s2(x, k7, gain, bias, 1.0,
                                                 4.0), 20)
        times["k9 wrapper"] = ms
        print(f"[{card}] K9 batch {bsz}: cuDNN f32 conv {lib:.4f} ms; "
              f"wrapper {ms:.4f} ms")
        for rows in sorted({1, 2, 4, 7, 8, 14, 16, 28, 32, plan}):
            if k9.stem_int8_smem(rows, 112) > k9._SMEM_TWO:
                continue
            out = k9._launch(x, wq, gq, bias, 1.0, 4.0, rows)
            same = torch.equal(out, ref)
            ms = _cuda_ms(lambda: k9._launch(x, wq, gq, bias, 1.0, 4.0,
                                             rows), 20)
            times[f"k9 rows {rows}"] = ms
            print(f"[{card}] K9 batch {bsz}, {rows} rows a tile: {ms:.4f} ms"
                  f" ({'bit-exact' if same else 'DIFFERS'})"
                  f"{'  <- plan' if rows == plan else ''}")
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
