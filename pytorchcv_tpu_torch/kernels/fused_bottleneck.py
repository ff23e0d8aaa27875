"""A chain of stride-1 int8 bottleneck units (K8), the counterpart of
``pytorchcv_tpu.kernels.fused_bottleneck``.

The int8 ResNet pipeline (``quant/resnet_int8.py``) runs each maximal run of
consecutive stride-1 bottleneck units with no identity conv and no SE, whose
output is int8, as one chain step. Per unit, with ``rq(v, q) = clip(rint(v *
q), +-127)`` and every step rounded in ``_cell``'s f32 order:

    t1 = rq(max(x @ W1 * A1 + B1, 0), q1)
    t2 = rq(max(conv3x3(t1) * A2 + B2, 0), q2)     (t1 zero padded)
    x  = rq(max(bf16(t2 @ W3 * A3 + B3) + bf16(x * R), 0), q3)

which is the K2 chain's arithmetic, so the chained plan gives the K2 plan's
int8 tensors bit for bit. On the card each unit is one launch of
``csrc/fused_bottleneck.cu``, whose t1 and t2 stay in shared memory; on CPU
tensors the chain runs its plain version, the ``_cell`` chain on K2's plain
version (the JAX module's ``fused_chain_xla_ref``).

Limits (the widths are checked when a plan is prepared, :func:`fits`): C and
M multiples of 4, M at most 1024. The feature map's width W is checked per
call: one output row's tile, ``3 (W + 2) M + W M`` bytes, must fit in the
219 KB of dynamic shared memory a block may hold beside its 8 KB of GEMM
staging (W <= 53 at M = 1024), or the call raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ._build import (LAUNCHES, autograd_records, check, f32, library,
                     require_cuda_or_cpu, stream_of)
from .int8_conv import int8_conv_reference

__all__ = ["pack_units", "fused_bottleneck_chain",
           "fused_bottleneck_chain_reference", "fits", "takes_unit",
           "row_tile"]

MAX_M = 1024
# Dynamic shared memory a block may hold beside its 8 KB of static GEMM
# staging; the second figure lets two blocks share an SM's 228 KB (1 KB
# each kept by the hardware).
_SMEM_ONE = 232_448 - 8_192
_SMEM_TWO = 233_472 // 2 - 1_024 - 8_192


def fits(c: int, m: int) -> bool:
    """Whether K8 takes a unit of input/output width ``c`` and mid width
    ``m``."""
    return c % 4 == 0 and m % 4 == 0 and 0 < m <= MAX_M and c > 0


def takes_unit(cells: Dict) -> bool:
    """Whether K8 takes a unit's body ({"conv1", "conv2", "conv3"} cells of
    the int8 pipeline): a 1x1 / 3x3 / 1x1 bottleneck C -> M -> M -> C with
    every stride and dilation 1 and widths within :func:`fits`."""
    c1, c2, c3 = cells["conv1"], cells["conv2"], cells["conv3"]
    m, c = c1["wq"].shape[0], c1["wq"].shape[3]
    return (tuple(c1["wq"].shape) == (m, 1, 1, c)
            and tuple(c2["wq"].shape) == (m, 3, 3, m)
            and tuple(c3["wq"].shape) == (c, 1, 1, m)
            and all(cell.get("stride", 1) == 1 and
                    cell.get("dilation", 1) == 1 for cell in (c1, c2, c3))
            and fits(c, m))


def _t1_bytes(th: int, w: int, m: int) -> int:
    return -(-((th + 2) * (w + 2) * m) // 16) * 16


def _smem(th: int, w: int, m: int) -> int:
    return _t1_bytes(th, w, m) + th * w * m


def _passes(h: int, w: int, c: int, m: int, th: int) -> int:
    """K8's multiply-add work for one image in tiles of ``th`` rows, costed
    as the tile count times one full tile: each conv runs in passes of 64
    pixels, so ragged pixel counts and conv1's two halo rows cost whole
    passes, and the blocks of one launch run side by side, so the largest
    tile sets the time."""
    halo = min(th + 2, h)
    return -(-h // th) * (-(-halo * w // 64) * c * m +
                          -(-th * w // 64) * (9 * m * m + m * c))


def row_tile(h: int, w: int, c: int, m: int) -> int:
    """Output rows a block takes: of the even splits of H (``ceil(H / n)``
    rows a tile) whose t1 and t2 fit in shared memory, the one with the
    least ``_passes``, among those that leave room for a second block on
    the SM unless a one-block tile needs under 3/4 of their work."""
    splits = sorted({-(-h // n) for n in range(1, h + 1)}, reverse=True)

    def best(budget):
        fit = [t for t in splits if _smem(t, w, m) <= budget]
        return min(fit, key=lambda t: _passes(h, w, c, m, t), default=None)
    two, one = best(_SMEM_TWO), best(_SMEM_ONE)
    if one is None:
        raise ValueError(f"fused_bottleneck: one row of W {w} at M {m} "
                         f"needs {_smem(1, w, m)} bytes of shared memory, "
                         f"more than the {_SMEM_ONE} a block may hold")
    if two is None or _passes(h, w, c, m, one) < \
            0.75 * _passes(h, w, c, m, two):
        return one
    return two


def pack_units(units: Sequence[Dict], s_chain: Sequence[float]) -> Dict:
    """Stack a run of units' cells into K8's operands.

    ``units``: [{"conv1": cell, "conv2": cell, "conv3": cell}] with the
    int8 pipeline's cells (``wq`` int8 (Cout, kh, kw, Cin), ``gain``,
    ``bias`` f32). ``s_chain``: [s_in, s2_0, s3_0, s_out_0 (= s_in_1), s2_1,
    ...], the activation scales along the chain. The f32 roundings are the
    JAX ``pack_units``': A = gain * f32(s / 127), q = f32(127 / s), R =
    f32(s_in / 127). Returns {"w1" (n, M, C), "w2" (n, M, 3, 3, M), "w3"
    (n, C, M) int8; "a1", "b1", "a2", "b2" (n, M), "a3", "b3" (n, C) f32;
    "q": [(q1, q2, q3)], "r": [R]} (q and R as Python floats)."""
    if len(s_chain) != 3 * len(units) + 1 or not units:
        raise ValueError(f"pack_units: {len(units)} units need "
                         f"{3 * len(units) + 1} scales, got {len(s_chain)}")
    cols: Dict[str, List] = {k: [] for k in
                             ("w1", "w2", "w3", "a1", "b1", "a2", "b2", "a3",
                              "b3", "q", "r")}
    for u, cells in enumerate(units):
        s_in, s2, s3, s_out = s_chain[3 * u:3 * u + 4]
        if not takes_unit(cells):
            raise ValueError(f"pack_units: unit {u} is not a stride-1 "
                             f"1x1 / 3x3 / 1x1 bottleneck K8 takes")
        c1, c2, c3 = cells["conv1"], cells["conv2"], cells["conv3"]
        m, c = c1["wq"].shape[0], c1["wq"].shape[3]
        cols["w1"].append(c1["wq"].reshape(m, c))
        cols["w2"].append(c2["wq"])
        cols["w3"].append(c3["wq"].reshape(c, m))
        for i, (cell, s) in enumerate(((c1, s_in), (c2, s2), (c3, s3)), 1):
            cols[f"a{i}"].append(cell["gain"] * f32(s / 127.0))
            cols[f"b{i}"].append(cell["bias"])
        cols["q"].append((f32(127.0 / s2), f32(127.0 / s3),
                          f32(127.0 / s_out)))
        cols["r"].append(f32(s_in / 127.0))
    packed = {k: torch.stack(v).contiguous() for k, v in cols.items()
              if k not in ("q", "r")}
    packed["q"], packed["r"] = cols["q"], cols["r"]
    return packed


def fused_bottleneck_chain_reference(xq: torch.Tensor,
                                     packed: Dict) -> torch.Tensor:
    """Plain PyTorch version of K8: the ``_cell`` chain on K2's plain
    version (exact float64 sums, the same f32 epilogues)."""
    x = xq
    for u, (q1, q2, q3) in enumerate(packed["q"]):
        m, c = packed["w1"].shape[1:]
        t = int8_conv_reference(x, packed["w1"][u].view(m, 1, 1, c),
                                packed["a1"][u], packed["b1"][u], 1, True, q1)
        t = int8_conv_reference(t, packed["w2"][u], packed["a2"][u],
                                packed["b2"][u], 1, True, q2)
        x = int8_conv_reference(t, packed["w3"][u].view(c, 1, 1, m),
                                packed["a3"][u], packed["b3"][u], 1, False,
                                q3, residual=x, res_scale=packed["r"][u],
                                round_res=True)
    return x


def fused_bottleneck_chain(xq: torch.Tensor, packed: Dict) -> torch.Tensor:
    """K8: ``xq`` int8 (B, H, W, C) through the packed units -> int8 (B, H,
    W, C). CUDA tensors run one launch a unit, CPU tensors the plain
    version; anything else raises, a call that autograd would record
    included (K8 has no backward)."""
    n, m, c = packed["w1"].shape
    if xq.dtype != torch.int8 or xq.dim() != 4 or xq.shape[3] != c:
        raise ValueError(f"fused_bottleneck: x must be int8 (B, H, W, {c}), "
                         f"got {xq.dtype} {tuple(xq.shape)}")
    if not fits(c, m):
        raise ValueError(f"fused_bottleneck: C {c} and M {m} must be "
                         f"multiples of 4 with M <= {MAX_M}")
    floats = [packed[k] for k in ("a1", "b1", "a2", "b2", "a3", "b3")]
    tensors = [xq, packed["w1"], packed["w2"], packed["w3"], *floats]
    if any(t.dtype != torch.int8 for t in tensors[1:4]) or \
            any(t.dtype != torch.float32 for t in floats):
        raise ValueError("fused_bottleneck: weights must be int8 and the "
                         "per-channel A, B float32")
    if autograd_records(*floats):
        raise ValueError("fused_bottleneck: K8 has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("fused_bottleneck", *tensors):
        return fused_bottleneck_chain_reference(xq, packed)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_bottleneck: inputs must be contiguous")
    bsz, h, w, _ = xq.shape
    if bsz > 65535 or xq.numel() >= 2 ** 31:
        raise ValueError(f"fused_bottleneck: x {tuple(xq.shape)} exceeds the "
                         f"kernel's grid")
    th = row_tile(h, w, c, m)
    lib = library()
    x = xq
    for u, (q1, q2, q3) in enumerate(packed["q"]):
        out = torch.empty_like(x)
        args = [packed[k][u].data_ptr() for k in
                ("w1", "w2", "w3", "a1", "b1", "a2", "b2", "a3", "b3")]
        with torch.cuda.device(x.device):
            check(lib.pcv_fused_bottleneck(
                x.data_ptr(), *args, q1, q2, q3, packed["r"][u],
                out.data_ptr(), bsz, h, w, c, m, th, _t1_bytes(th, w, m),
                _smem(th, w, m), stream_of(x)), "fused_bottleneck")
        LAUNCHES["fused_bottleneck"] += 1
        x = out
    return x
