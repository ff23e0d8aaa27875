"""K6 (depthwise conv + folded BN + activation) and ``maxpool_i8`` timed
under their plans' alternatives on the card:

    python -m pytorchcv_tpu_torch.kernels.dwconv_plans [batch]

Needs one CUDA card and nvcc. K6 at each distinct depthwise call of a
224x224 bf16 ``efficientnet_b0`` forward at ``batch`` (default 128; seeded
random weights and inputs): the kernel alone on the device
(``torch.profiler``) under :func:`dwconv_plan`'s plan and under the
cheapest alternatives of :func:`_plan_cost` (the best few overall, the
best two of each strip width, and of each width the tiles nearest 1, 2
and 4 rounds of 256 strips and 1 and 2 of 128), each checked within 1
bf16 ulp of the plain version and timed beside its modelled cost,
then cuDNN's depthwise conv alone and the call's bytes bound; the sums
over the forward's 16 calls under the plan and under each call's fastest.
``maxpool_i8`` at ResNet-50's stem map (128, 112, 112, 64) and DANet's
(8, 240, 240, 128) under each vector width and run of output rows, beside
the plan. Times are ms a call; the last line is one JSON object with
every time.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from . import dwconv as k6
from . import stem
from ._parts import HBM_BYTES_S
from ._parts import card as card_name
from ._parts import device_ms
from .preprocess import bf16_ulp_error

def _b0_calls(batch):
    """The (x, w, scale, shift, stride, pad, act) of each depthwise call
    of a bf16 efficientnet_b0 forward at 224x224."""
    import pytorchcv_tpu_torch as pt
    import pytorchcv_tpu_torch.nn.conv as conv_mod
    from pytorchcv_tpu_torch.serve import as_bfloat16
    calls = []
    orig = conv_mod.dwconv2d_bn_act

    def rec(*a):
        calls.append(a)
        return orig(*a)
    model = as_bfloat16(pt.get_model("efficientnet_b0", rng=0,
                                     device="cpu")).cuda()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((batch, 3, 224, 224), generator=g).to(torch.bfloat16)
    conv_mod.dwconv2d_bn_act = rec
    try:
        with torch.inference_mode():
            model(x.cuda())
    finally:
        conv_mod.dwconv2d_bn_act = orig
    torch.cuda.synchronize()
    return calls


def _alternatives(x, w, stride, pad):
    """The plan, the cheapest few plans by the model and the cheapest two
    of each strip width, with their modelled costs."""
    n, c, h, wd = x.shape
    k = w.shape[-1]
    (top, bottom), (left, right) = pad
    ho = (h + top + bottom - k) // stride + 1
    wo = (wd + left + right - k) // stride + 1
    es = x.element_size()
    cost = {p: k6._plan_cost(n * c, h, wd, ho, wo, k, stride, es, p)
            for p in k6._candidates(h, wd, ho, wo, k, stride, es)}
    ranked = sorted(cost, key=cost.get)
    pick = ranked[:4]
    for v in k6._VS:
        pick += [p for p in ranked if p.v == v][:2]
        # tiles of about 1, 2 and 4 rounds of 256 strips, 1 and 2 of 128
        for threads, rounds in ((256, 1), (256, 2), (256, 4), (128, 1),
                                (128, 2)):
            same = [p for p in ranked if p.v == v and p.threads == threads]
            if same:
                spr = -(-wo // v)
                pick.append(min(same, key=lambda p: abs(
                    p.planes * p.rows * spr - rounds * threads)))
    plan = k6.dwconv_plan(n, c, h, wd, k, stride, pad, x.dtype)
    return plan, {p: cost[p] for p in dict.fromkeys([plan] + pick)}


def main() -> None:
    with torch.inference_mode():
        _main(int(sys.argv[1]) if len(sys.argv) > 1 else 128)


def _main(batch: int) -> None:
    card = card_name()
    times = {}
    seen, counts = {}, {}
    for a in _b0_calls(batch):
        key = (tuple(a[0].shape), a[1].shape[-1], a[4], a[5])
        seen.setdefault(key, a)
        counts[key] = counts.get(key, 0) + 1
    sum_plan = sum_best = sum_lib = sum_bound = 0.0
    for i, (key, a) in enumerate(seen.items()):
        x, w, scale, shift, stride, pad, act = a
        count = counts[key]
        plan, alts = _alternatives(x, w, stride, pad)
        ref = k6.dwconv2d_bn_act_reference(*a)
        out = k6.dwconv2d_bn_act(*a)
        ulp = float(bf16_ulp_error(out, ref).max())
        if ulp > 1:
            raise RuntimeError(f"K6 at {key} differs by {ulp} bf16 ulp")
        bound = (sum(t.numel() * t.element_size()
                     for t in (x, w, scale, shift, out))
                 / HBM_BYTES_S * 1e3)
        lib = device_ms(lambda: F.conv2d(
            x, w, None, stride, (pad[0][0], pad[1][0]), 1, x.shape[1]), "")
        best = None
        for p, cost in alts.items():
            got = k6._launch(x, w, scale, shift, stride, pad, act, p)
            if float(bf16_ulp_error(got, ref).max()) > 1:
                raise RuntimeError(f"K6 at {key} under {p} differs")
            ms = device_ms(lambda: k6._launch(x, w, scale, shift, stride,
                                               pad, act, p), "dwconv")
            times[f"k6 call {i + 1} {tuple(p)}"] = ms
            best = ms if best is None else min(best, ms)
            print(f"[{card}] K6 call {i + 1} x {key[0]} k {key[1]} s "
                  f"{key[2]} pad {key[3]}: plan v {p.v}, {p.planes} planes x"
                  f" {p.rows} rows, {p.threads} threads: {ms:.4f} ms "
                  f"(model {cost:.0f}){'  <- plan' if p == plan else ''}")
        ms_plan = times[f"k6 call {i + 1} {tuple(plan)}"]
        print(f"[{card}] K6 call {i + 1} (x{count} a forward): plan "
              f"{ms_plan:.4f} ms, fastest {best:.4f}, cuDNN depthwise conv "
              f"alone {lib:.4f}, bound {bound:.4f} ms "
              f"({ms_plan / bound:.1f}x)")
        times[f"k6 call {i + 1} cudnn"] = lib
        sum_plan += count * ms_plan
        sum_best += count * best
        sum_lib += count * lib
        sum_bound += count * bound
    print(f"[{card}] K6 over the {sum(counts.values())} calls of a forward "
          f"({len(seen)} distinct) at batch {batch}:"
          f" plan {sum_plan:.4f} ms, each call's fastest {sum_best:.4f}, "
          f"cuDNN depthwise conv alone {sum_lib:.4f}, bound "
          f"{sum_bound:.4f}")
    times.update({"k6 plan sum": sum_plan, "k6 fastest sum": sum_best,
                  "k6 cudnn sum": sum_lib, "k6 bound sum": sum_bound})

    g = torch.Generator().manual_seed(2)
    for tag, shape in (("resnet50", (128, 112, 112, 64)),
                       ("danet", (8, 240, 240, 128))):
        x = torch.randint(-128, 128, shape, generator=g,
                          dtype=torch.int8).cuda()
        ref = stem.maxpool_i8_reference(x)
        out = torch.empty_like(ref)
        plan = stem.maxpool_plan(*shape, 16)
        bound = (x.numel() + ref.numel()) / HBM_BYTES_S * 1e3
        for vb in (16, 8, 4):
            for run in (1, 2, 4, 8, 16):
                got = stem._pool_launch(x, out, vb, run)
                if not torch.equal(got, ref):
                    raise RuntimeError(f"maxpool_i8 {vb} {run} differs")
                ms = device_ms(lambda: stem._pool_launch(x, out, vb, run),
                                "maxpool")
                times[f"pool {tag} {vb} {run}"] = ms
                print(f"[{card}] maxpool_i8 {tag} {shape}: {vb}-byte "
                      f"vectors, {run} rows a thread: {ms:.4f} ms, bound "
                      f"{bound:.4f}{'  <- plan' if (vb, run) == plan else ''}")
        info = stem.maxpool_info(plan[0])
        print(f"[{card}] maxpool_i8 {plan[0]}-byte instance: "
              f"{info['registers']} registers, {info['spill_bytes']} bytes "
              f"spilled")
    print(json.dumps({"card": card, "batch": batch, "ms": times}))


if __name__ == "__main__":
    main()
