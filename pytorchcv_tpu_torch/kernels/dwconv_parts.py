"""Where K6's time goes: the kernel timed with parts of its work taken out
of copies of ``csrc/dwconv.cu``.

    python -m pytorchcv_tpu_torch.kernels.dwconv_parts [batch]

Needs one CUDA card and nvcc. Builds each variant into a temporary
directory (one nvcc per variant, in parallel) and times it, under the
plan's tile, on five of EfficientNet-B0's depthwise calls at ``batch``
(default 128; bf16, swish, seeded inputs): 112x112 k3 s1 (C 32), 112x112
k3 s2 (C 96), 56x56 k3 s1 (C 144), 28x28 k5 s1 (C 240) and 7x7 k5 s1
(C 1152), with CUDA events over 20 launches after 3, beside the call's
bytes bound. The variants compute wrong outputs on purpose; only their
times mean anything. The differences between them say what each part
costs: the span's copy into shared memory, its layout, the taps (with
their shared loads), the epilogue, and the output's write; "one strip
loop" (right outputs) drops swish's own instance of the strip loop. The
last line is one JSON object with the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import sys
import tempfile

import torch

from . import dwconv as k6
from ._build import _CSRC
from ._parts import HBM_BYTES_S, build, card, cuda_ms
_CALLS = ((32, 112, 3, 1), (96, 112, 3, 2), (144, 56, 3, 1), (240, 28, 5, 1),
          (1152, 7, 5, 1))     # C, H = W, k, stride (pad k // 2)

_TAPS = """          if constexpr (sizeof(T) == 2)
            acc[j] = __fmaf_rn(xv, wr[di * K + dj], acc[j]);
          else
            acc[j] = __fadd_rn(acc[j], __fmul_rn(xv, wr[di * K + dj]));"""
_EPILOGUE = """        o[j] = from_f32<T>(activate<sizeof(T) == 2>(
            __fadd_rn(__fmul_rn(acc[j], sc), sh), ACT < 0 ? act : ACT));"""
_LAYOUT = ("""          out_row[S == 1 ? pc : (pc & 1) * g.half + (pc >> 1)] =
              to_f32(in_row[ix]);""",
           """        xs[pl * g.plane_pitch + sr * g.row_pitch +
           (S == 1 ? pc : (pc & 1) * g.half + (pc >> 1))] = to_f32(span[e]);""")
_SWISH_APART = """  if (a.act == 5)
    strips_of<T, K, S, V, 5>(xs, ws, scs, shs, ost, g, a.div_spr, div_plane,
                             q.np * per_plane, q.nr, Wo, a.act);
  else
    strips_of<T, K, S, V, -1>(xs, ws, scs, shs, ost, g, a.div_spr, div_plane,
                              q.np * per_plane, q.nr, Wo, a.act);"""
_ONE_LOOP = """  strips_of<T, K, S, V, -1>(xs, ws, scs, shs, ost, g, a.div_spr, div_plane,
                            q.np * per_plane, q.nr, Wo, a.act);"""
_COPY = """    pcv::cp_async16(raw + 16 * ch,
                    reinterpret_cast<const void*>(c0 + 16 * ch), 16);"""
_WRITE = ("""  for (int i = tid; i < head; i += nth) dst[i] = ost[i];""",
          """    reinterpret_cast<uint4*>(dst + head)[i] =
        reinterpret_cast<const uint4*>(ost + head)[i];""",
          """  for (int i = tail0 + tid; i < total; i += nth) dst[i] = ost[i];""")


def _cut(src: str, *parts: str, by: str = "") -> str:
    for part in parts:
        if part not in src:
            raise RuntimeError(f"the kernel source no longer holds {part!r}")
        src = src.replace(part, by)
    return src


def variants(src: str) -> dict:
    """Name -> source: the kernel and copies with parts removed."""
    no_epi = _cut(src, _EPILOGUE, by="        o[j] = from_f32<T>(acc[j]);")
    no_taps = _cut(no_epi, _TAPS)
    return {
        "kernel": src,
        "no epilogue": no_epi,
        "no epilogue, no taps": no_taps,
        "no layout": _cut(src, *_LAYOUT, by=";"),
        "no copy": _cut(src, _COPY, by=";"),
        "no output write": _cut(src, *_WRITE, by=";"),
        "copy and write only": _cut(no_taps, *_LAYOUT, by=";"),
        "one strip loop": _cut(src, _SWISH_APART, by=_ONE_LOOP),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("dwconv_parts needs a CUDA card")
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    src = (_CSRC / "dwconv.cu").read_text()
    name_card = card()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)
    cases = []
    for c, hw, k, stride in _CALLS:
        x = (torch.randn((batch, c, hw, hw), generator=g) * 2).to(
            "cuda", torch.bfloat16)
        w = (torch.randn((c, 1, k, k), generator=g) * 0.3).to(
            "cuda", torch.bfloat16)
        scale = torch.empty(c).uniform_(0.5, 1.5, generator=g).cuda()
        shift = (torch.randn(c, generator=g) * 0.3).cuda()
        p = k // 2
        pad = ((p, p), (p, p))
        ho = (hw + 2 * p - k) // stride + 1
        out = torch.empty((batch, c, ho, ho), dtype=torch.bfloat16,
                          device="cuda")
        plan = k6.dwconv_plan(batch, c, hw, hw, k, stride, pad, x.dtype)
        geo = k6.tile_geometry(hw, hw, ho, ho, k, stride, plan.v,
                               plan.planes, plan.rows, 2)
        bound = (2 * (x.numel() + out.numel()) / HBM_BYTES_S * 1e3)
        cases.append(((c, hw, k, stride), (x, w, scale, shift, out), plan,
                      geo, ho, bound))
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, lib in build(variants(src), tmp).items():
            fn = lib.pcv_dwconv
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 19 + [
                ctypes.c_void_p]
            for key, (x, w, scale, shift, out), plan, geo, ho, bound in cases:
                c, hw, k, stride = key

                def call():
                    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                             shift.data_ptr(), out.data_ptr(), batch, c, hw,
                             hw, ho, ho, k, stride, k // 2, k // 2, 5, 1,
                             plan.v, plan.planes, plan.rows, plan.threads,
                             geo.row_pitch, geo.half, geo.plane_pitch,
                             stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms = cuda_ms(call, 20, 3)
                times[f"{key} {name}"] = ms
                print(f"[{name_card}] K6 x ({batch}, {c}, {hw}, {hw}) k {k} "
                      f"s {stride}, plan {tuple(plan)}, {name}: {ms:.4f} ms "
                      f"(bound {bound:.4f})")
    print(json.dumps({"card": name_card, "batch": batch, "ms": times}))


if __name__ == "__main__":
    main()
