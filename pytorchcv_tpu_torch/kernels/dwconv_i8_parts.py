"""Where K12's time goes (its work cut into parts), and its plans.

    python -m pytorchcv_tpu_torch.kernels.dwconv_i8_parts [batch] [SOURCE]
    python -m pytorchcv_tpu_torch.kernels.dwconv_i8_parts plans [batch]

Needs one CUDA card and nvcc. Every distinct K12 call of one int8
``mobilenetv2_w1`` and one ``mobilenet_w1`` forward at 224x224 and
``batch`` (default 128; seeded int8 inputs and weights, ReLU6 / ReLU), each
timed on the device (``_parts.graph_ms``: 20 launches captured into a CUDA
graph, replayed between CUDA events; the short calls' launches take longer
on the host than on the card, so back-to-back launches would time the
host), and per forward (each call times its count) beside its bytes
bound.

Parts: copies of SOURCE (default this tree's ``csrc/dwconv_i8.cu``; the
first design, from an earlier checkout, is told by its channel-vector walk)
with parts of the work taken out, each built by its own nvcc in parallel
under the plan's launch. The variants compute wrong outputs on purpose;
only their times mean anything. Their differences say what each part
costs: the epilogue, the taps (products and sums; for the second design
the windows and ``__dp4a``), the byte transpose, and what is left: the
loads, the walk and the stores.

Plans: the kernel of this tree under every output rows a thread, by call,
beside the plan's choice, with each instance's registers and spills. The last line is one JSON object with the
times in ms.
"""

from __future__ import annotations

import ctypes
import json
import sys
import tempfile
from collections import Counter

import torch

from . import dwconv_i8 as k12
from ._build import _CSRC
from ._parts import HBM_BYTES_S, build, card, graph_ms

_NAMES = ("mobilenetv2_w1", "mobilenet_w1")

# The second design's parts (csrc/dwconv_i8.cu)
_EPILOGUE = "      e[c] = epilogue(acc, ga[c], bb[c], a);"
_TAPS = """        acc = __dp4a(static_cast<int>(window<J * S>(rows[(R0 + di) % 3][c])),
                     static_cast<int>(wrow[c][di]), acc);"""
_TRANSPOSE = """      const unsigned t0 = __byte_perm(p0, p1, 0x5140);
      const unsigned t1 = __byte_perm(p0, p1, 0x7362);
      const unsigned t2 = __byte_perm(p2, p3, 0x5140);
      const unsigned t3 = __byte_perm(p2, p3, 0x7362);
      row[0][k] = __byte_perm(t0, t2, 0x5410);
      row[1][k] = __byte_perm(t0, t2, 0x7632);
      row[2][k] = __byte_perm(t1, t3, 0x5410);
      row[3][k] = __byte_perm(t1, t3, 0x7632);"""
# The first design's parts (its 16-byte channel-vector walk)
_FIRST_EPILOGUE = """        const float a = __ldg(gain_a + cb + c), bb = __ldg(bias_b + cb + c);
        const float y = pcv::activate_i8(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[c]), a), bb), act);
        word |= static_cast<unsigned>(static_cast<unsigned char>(
                    pcv::quant_i8(y, q)))
                << (8 * j);"""
_FIRST_TAPS = ("            acc[4 * k + j] += sbyte(xv.w[k], j) * "
               "sbyte(wv.w[k], j);")


def _cut(src: str, part: str, by: str) -> str:
    if part not in src:
        raise RuntimeError(f"the kernel source no longer holds {part!r}")
    return src.replace(part, by)


def _first(src: str) -> bool:
    return "struct Vec" in src


def variants(src: str) -> dict:
    """Name -> source: the kernel and copies with parts removed."""
    if _first(src):
        no_epi = _cut(src, _FIRST_EPILOGUE, "        word |= static_cast<"
                      "unsigned>(acc[c] & 0xff) << (8 * j);")
        taps_by = ("            if (j == 0) acc[4 * k] += "
                   "static_cast<int>(xv.w[k]);")
        return {"kernel": src, "no epilogue": no_epi,
                "no products": _cut(src, _FIRST_TAPS, taps_by),
                "loads and stores only": _cut(no_epi, _FIRST_TAPS, taps_by)}
    no_epi = _cut(src, _EPILOGUE, "      e[c] = static_cast<unsigned>(acc);")
    taps_by = ("        acc += static_cast<int>(rows[(R0 + di) % 3][c]"
               "[(J * S) / 4]);")
    no_taps = _cut(no_epi, _TAPS, taps_by)
    plain_rows = ("      row[0][k] = p0; row[1][k] = p1; row[2][k] = p2; "
                  "row[3][k] = p3;")
    return {"kernel": src, "no epilogue": no_epi,
            "no epilogue, no taps": no_taps,
            "no transpose": _cut(src, _TRANSPOSE, plain_rows),
            "loads and stores only": _cut(no_taps, _TRANSPOSE, plain_rows)}


def _cases(batch: int):
    """[(name, ((B, H, W, C), stride, act), count a forward, operands,
    bound ms)] over the distinct calls of both paths."""
    g = torch.Generator().manual_seed(0)
    cases = []
    for name in _NAMES:
        for (shape, stride, act), n in sorted(Counter(
                k12.call_shapes(name, batch=batch)).items()):
            c = shape[3]
            x = torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8).cuda()
            w = torch.randint(-127, 128, (3, 3, c), generator=g,
                              dtype=torch.int8).cuda()
            a = (torch.rand(c, generator=g) * 1.3e-3 + 2e-4).cuda()
            b = (torch.randn(c, generator=g) * 2).cuda()
            ho, wo = ((n_ - 1) // stride + 1 for n_ in shape[1:3])
            out = torch.empty((shape[0], ho, wo, c), dtype=torch.int8,
                              device="cuda")
            nbytes = x.numel() + w.numel() + 8 * c + out.numel()
            cases.append((name, (shape, stride, act), n, (x, w, a, b, out),
                          nbytes / HBM_BYTES_S * 1e3))
    return cases


def _parts(batch: int, src: str, name_card: str) -> dict:
    first = _first(src)
    cases = _cases(batch)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for vname, lib in build(variants(src), tmp).items():
            fn = lib.pcv_dwconv_i8
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p] + \
                [ctypes.c_int] * 9 + [ctypes.c_void_p]
            fwd = Counter()
            for path, (shape, stride, act), n, ops, bound in cases:
                x, w, a, b, out = ops
                plan = (16, 2) if first else tuple(k12.dwconv_i8_plan(
                    *shape, stride, 256))

                def call():
                    # the current stream: the capturing one in graph_ms
                    err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(),
                             b.data_ptr(), 9.7, k12.ACTS_I8[act],
                             out.data_ptr(), *shape[:3], out.shape[1],
                             out.shape[2], shape[3], stride, *plan,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{vname}: CUDA error {err}")
                ms = graph_ms(call, 20)
                fwd[path] += n * ms
                times[f"{path} {shape} s{stride} {vname}"] = ms
                print(f"[{name_card}] K12 {'first design' if first else ''}"
                      f" {path} x {shape} s {stride} (x{n}), plan {plan}, "
                      f"{vname}: {ms:.4f} ms (bound {bound:.4f})")
            for path in _NAMES:
                bound = sum(n * bd for p, _, n, _, bd in cases if p == path)
                times[f"{path} forward {vname}"] = fwd[path]
                print(f"[{name_card}] K12 {path} forward, {vname}: "
                      f"{fwd[path]:.4f} ms (bound {bound:.4f})")
    return times


def _rows_options(ho: int, plan_rows: int):
    return sorted({r for r in (1, 2, 3, 4, 6, 8, 12, 16, 28, ho, plan_rows)
                   if r <= ho})


def _plans(batch: int, name_card: str) -> dict:
    times = {}
    fwd_plan, fwd_best = Counter(), Counter()
    for path, (shape, stride, act), n, ops, bound in _cases(batch):
        x, w, a, b, out = ops
        ho = out.shape[1]
        chosen = k12.dwconv_i8_plan(*shape, stride, 256)
        res = {}
        for rows in _rows_options(ho, chosen.rows):
            plan = k12.K12Plan(chosen.cpt, rows)
            res[plan] = graph_ms(lambda: k12._launch(
                x, w, a, b, 9.7, stride, act, out, plan), 20)
        best = min(res, key=res.get)
        fwd_plan[path] += n * res[chosen]
        fwd_best[path] += n * res[best]
        key = f"{path} {shape} s{stride}"
        times[key] = {str(tuple(p)): ms for p, ms in res.items()}
        top = sorted(res, key=res.get)[:4]
        print(f"[{name_card}] K12 {path} x {shape} s {stride} (x{n}), bound "
              f"{bound:.4f} ms: plan {tuple(chosen)} {res[chosen]:.4f} ms; "
              f"fastest " + ", ".join(f"{tuple(p)} {res[p]:.4f}"
                                      for p in top))
    for path in _NAMES:
        print(f"[{name_card}] K12 {path} forward: plan {fwd_plan[path]:.4f} "
              f"ms, each call's fastest {fwd_best[path]:.4f} ms")
        times[f"{path} forward plan"] = fwd_plan[path]
        times[f"{path} forward fastest"] = fwd_best[path]
    for cpt, s in k12.INSTANCES:
        info = k12.kernel_info(cpt, s)
        print(f"[{name_card}] K12 instance cpt {cpt} s {s}: "
              f"{info['registers']} registers, "
              f"{info['spill_bytes']} bytes spilled")
    return times


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("dwconv_i8_parts needs a CUDA card")
    args = sys.argv[1:]
    plans = bool(args) and args[0] == "plans"
    if plans:
        args = args[1:]
    batch = int(args[0]) if args else 128
    name_card = card()
    with torch.inference_mode():
        if plans:
            times = _plans(batch, name_card)
        else:
            path = args[1] if len(args) > 1 else _CSRC / "dwconv_i8.cu"
            with open(path) as f:
                times = _parts(batch, f.read(), name_card)
    print(json.dumps({"card": name_card, "batch": batch, "ms": times}))


if __name__ == "__main__":
    main()
