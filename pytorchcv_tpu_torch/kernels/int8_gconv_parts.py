"""Where the grouped K2's time goes: the kernel timed with parts of its work
taken out of copies of ``csrc/int8_gconv.cu``.

    python -m pytorchcv_tpu_torch.kernels.int8_gconv_parts [batch]

Needs one CUDA card and nvcc. Builds each variant into a temporary
directory (one nvcc per variant, in parallel) and times it, under the
plan's tile, on four of ResNeXt-50's grouped convs at ``batch`` (default
128; int8 operands from numpy seed 0, int8 output with ReLU): stage 1
(56x56, cg 4), stage 2's strided first (56 -> 28, cg 8), stage 3 (14x14,
cg 16) and stage 4 (7x7, cg 32), by device time (``torch.profiler`` over
10 launches after 1: ``_parts.launch_ms``), beside the conv's bytes
bound. The variants compute wrong outputs on purpose; only their times
mean anything. The differences between them say what each part costs:
the products (mma), A's shared loads, the halo's copies, the epilogue
(its arithmetic and stores), what is left without all of them (the tile
loop's frame: its index work, the output tile's staging, the barriers),
that frame without its epilogue loop or its products loop, and the
prologue alone (the block's tables, no tile). The last line is one JSON
object with the times in ms.
"""

from __future__ import annotations

import json
import sys
import tempfile

import numpy as np
import torch

from . import int8_conv as k2
from ._build import _CSRC, _SIGNATURES, f32
from ._parts import HBM_BYTES_S, build, card, launch_ms
from .int8_conv_plans import out_hw

_MMA = "mma_s8(acc[mt][v * U + u], a, bb[u].x, bb[u].y);"
_A = ("          const uint2 lo =\n"
      "              *reinterpret_cast<const uint2*>(region + rb[mt][0] + "
      "off);\n"
      "          const uint2 hi =\n"
      "              *reinterpret_cast<const uint2*>(region + rb[mt][1] + "
      "off);")
_HALO = """        if (p.vec == 16)
          cp_async16(dst, src, in ? 16 : 0);
        else if (p.vec == 8)
          cp_async8(dst, src, in ? 8 : 0);"""
_EPI = "      pcv::epilogue8("
_EPI_LOOP = "    for (int r = tid / NB; r < BM; r += kThreads / NB) {"
_C_LOOP = "    for (int c = 0; c < CH; ++c) {"
_TILE_LOOP = ("  for (int sp = blockIdx.x / p.n_ct; sp < p.n_sp; "
              "sp += p.g_sp) {")
# (k, stride, cin, cout, groups, h, w)
_CONVS = ((3, 1, 128, 128, 32, 56, 56), (3, 2, 256, 256, 32, 56, 56),
          (3, 1, 512, 512, 32, 14, 14), (3, 1, 1024, 1024, 32, 7, 7))


def _cut(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"int8_gconv_parts: {old[:40]!r} is not in the "
                           f"kernel source any more")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """Name -> source: the kernel and copies with parts removed."""
    no_mma = _cut(src, _MMA, "acc[mt][v * U + u][0] += a[0] ^ a[1] ^ a[2] ^ "
                             "a[3] ^ bb[u].x ^ bb[u].y;")
    no_epi = _cut(src, _EPI, "      if (h0.x == 123456789) pcv::epilogue8(")
    no_halo = _cut(src, _HALO, "        if (p.vec >= 8)\n"
                               "          (void)in;")
    frame = _cut(_cut(
        _cut(no_halo, _MMA, "acc[mt][v * U + u][0] += a[0] ^ bb[u].x;"),
        _EPI, "      if (h0.x == 123456789) pcv::epilogue8("), _A,
        "          const uint2 lo = make_uint2(rb[mt][0] + off, 0), hi = lo;")
    return {
        "kernel": src,
        "no products": no_mma,
        "no products, no A loads": _cut(
            no_mma, _A, "          const uint2 lo = make_uint2(rb[mt][0] + "
                        "off, 0), hi = make_uint2(rb[mt][1], off);"),
        "no halo copies": no_halo,
        "no epilogue": no_epi,
        "no epilogue, no products": _cut(no_epi, _MMA, "acc[mt][v * U + u]"
                                         "[0] += a[0] ^ bb[u].x;"),
        "none of them (the tile loop's frame)": frame,
        "the frame without its epilogue loop": _cut(
            frame, _EPI_LOOP, "    for (int r = BM; r < BM; "
                              "r += kThreads / NB) {"),
        "the frame without its products loop": _cut(
            frame, _C_LOOP, "    for (int c = CH; c < CH; ++c) {"),
        "the prologue alone": _cut(src, _TILE_LOOP, "  for (int sp = p.n_sp; "
                                   "sp < p.n_sp; sp += p.g_sp) {"),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("int8_gconv_parts needs a CUDA card")
    bsz = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    name_card = card()
    rng = np.random.default_rng(0)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants((_CSRC / "int8_gconv.cu").read_text()), tmp)
        for conv in _CONVS:
            k, st, cin, cout, groups, h, w = conv
            ho, wo = out_hw((k, st, 1, cin, cout, h, w, False))
            x = torch.from_numpy(rng.integers(-127, 128, (bsz, h, w, cin),
                                              dtype=np.int8)).cuda()
            wt = torch.from_numpy(rng.integers(
                -127, 128, (cout, k, k, cin // groups), dtype=np.int8)).cuda()
            a = torch.from_numpy(rng.uniform(2e-5, 2e-4, cout).astype(
                np.float32)).cuda()
            b = torch.from_numpy(rng.standard_normal(cout).astype(
                np.float32)).cuda()
            out = torch.empty((bsz, ho, wo, cout), dtype=torch.int8,
                              device="cuda")
            p = k2.gconv_plan(bsz, h, w, cin, cout, groups, k, st, 1)
            nbytes = x.numel() + wt.numel() + 8 * cout + out.numel()
            stream = torch.cuda.current_stream().cuda_stream
            for name, lib in libs.items():
                fn = lib.pcv_int8_gconv
                fn.argtypes = _SIGNATURES["pcv_int8_gconv"]

                def call():
                    err = fn(x.data_ptr(), wt.data_ptr(), a.data_ptr(),
                             b.data_ptr(), None, 0.0, k2._RES_NONE, 1,
                             f32(0.7), 1, out.data_ptr(), None, bsz, h, w,
                             cin, ho, wo, cout, k, st, k // 2, 1, groups,
                             p.bm, p.bn, p.u, p.imgs, p.th, p.tw, p.vec,
                             p.wb, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms, _, _ = launch_ms(call, "int8_gconv_kernel")
                if ms is None:
                    raise RuntimeError(f"{name}: the profiler recorded no "
                                       f"grouped K2")
                key = f"{name}: x {(bsz, h, w, cin)} s{st}"
                times[key] = ms
                print(f"[{name_card}] grouped K2 {key} (tile {p.bm}x{p.bn}, "
                      f"{p.imgs}x{p.th}x{p.tw}, {p.ch} chunks): {ms:.4f} ms "
                      f"on the device (bound {nbytes / HBM_BYTES_S * 1e3:.4f}"
                      f" ms, bytes)")
    print(json.dumps({"card": name_card, "batch": bsz, "ms": times}))


if __name__ == "__main__":
    main()
