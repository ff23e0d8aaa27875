"""Where K8's time goes: the kernel timed with parts of its work taken out
of copies of ``csrc/fused_bottleneck.cu``.

    python -m pytorchcv_tpu_torch.kernels.fused_bottleneck_parts

Needs one CUDA card and nvcc. Builds each variant into a temporary
directory (one nvcc per variant, in parallel) and times one launch of it
under the plan :func:`fused_bottleneck.plan` picks, at ResNet-50's stage-1,
-3 and -4 and WRN-50-2's stage-4 unit shapes at batch 128 (one unit's
operands drawn as in ``fused_bottleneck_plans``, numpy seed 0), with CUDA
events over 10 launches after 2. The variants compute wrong outputs on
purpose; only their times mean anything. The differences between them say
what each part costs: the epilogues (requantization, the residual tail,
their stores), the residual's x loads, the per-channel A and B loads, the
weight ring's copies, the products, and the A operand's ldmatrix. The last
line is one JSON object with the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import tempfile

import numpy as np
import torch

from . import fused_bottleneck as fb
from ._build import _CSRC
from ._parts import build, card, cuda_ms
from .fused_bottleneck_plans import _unit

_MMA = "mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);"
_RING = "cp_async16(dst, valid > 0 ? src : any, valid > 0 ? 16 : 0);"
_X = """xv[nt] = *reinterpret_cast<const char2*>("""
_AB = """av[nt] = make_float2(__ldg(ea + n), __ldg(ea + n + 1));
        bv[nt] = make_float2(__ldg(eb + n), __ldg(eb + n + 1));"""
_SHAPES = [(128, 56, 56, 256, 64), (128, 14, 14, 1024, 256),
           (128, 7, 7, 2048, 512), (128, 7, 7, 2048, 1024)]


def _cut(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"fused_bottleneck_parts: {old[:40]!r} is not in "
                           f"the kernel source any more")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """Name -> source: the kernel and copies with parts removed."""
    no_mma = _cut(src, _MMA, "acc[mt][nt][0] += a[0] ^ b[nt][0] ^ b[nt][1];")
    return {
        "kernel": src,
        "no epilogues": _cut(src, "if (cc.pass_end()) {",
                             "if (acc[0][0][0] == 123456789 && "
                             "cc.pass_end()) {"),
        "no residual x loads": _cut(
            src, _X, "xv[nt] = make_char2(nt, mt), (void)("),
        "no A, B loads": _cut(
            src, _AB, "av[nt] = make_float2(n * 1e-3f, 1e-3f);\n"
            "        bv[nt] = make_float2(0.5f, n * 1e-4f);"),
        "no ring copies": _cut(src, _RING, ""),
        "no products": no_mma,
        "no products, no A ldmatrix": _cut(
            no_mma, "ldmatrix_x4(a, pa);",
            "a[0] = a[1] = a[2] = a[3] = (uint32_t)(uintptr_t)pa;"),
        "no products, no ring copies": _cut(no_mma, _RING, ""),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("fused_bottleneck_parts needs a CUDA card")
    name_card = card()
    rng = np.random.default_rng(0)
    inputs = [(s, *_unit(rng, *s, "cuda")) for s in _SHAPES]
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants((_CSRC / "fused_bottleneck.cu").read_text()),
                     tmp)
        for name, lib in libs.items():
            fn = lib.pcv_fused_bottleneck
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_float] * 4 +
                           [ctypes.c_void_p] + [ctypes.c_int] * 8 +
                           [ctypes.c_void_p])
            for (b, h, w, c, m), x, packed in inputs:
                th, tw = fb.plan(b, h, w, c, m)
                out = torch.empty_like(x)
                args = [packed[k][0].data_ptr() for k in
                        ("w1", "w2", "w3", "a1", "b1", "a2", "b2", "a3",
                         "b3")]
                q1, q2, q3 = packed["q"][0]

                def call():
                    err = fn(x.data_ptr(), *args, q1, q2, q3,
                             packed["r"][0], out.data_ptr(), b, h, w, c, m,
                             th, tw, fb._smem(th, tw, m), stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                key = f"{name}: x {(b, h, w, c)} M {m}"
                times[key] = cuda_ms(call)
                print(f"[{name_card}] K8 {key} (plan {th} x {tw} a tile): "
                      f"{times[key]:.4f} ms")
    print(json.dumps({"card": name_card, "ms": times}))


if __name__ == "__main__":
    main()
