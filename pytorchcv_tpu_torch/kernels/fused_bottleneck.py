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
call: one output row's t1 and t2, ``3 (W + 2) M`` (rounded up to 16) plus
``W M`` bytes, must fit in 219 KB (W <= 53 at M = 1024, W <= 108 at M =
512), or the call raises. :func:`plan` picks a block's output tile: whole
rows, or where one row leaves no room for the kernel's 36 KB weight ring
(W > 46 at M = 1024), one row in column tiles.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from ._build import (LAUNCHES, autograd_records, check, f32, library,
                     require_cuda_or_cpu, stream_of)
from .int8_conv import int8_conv_reference

__all__ = ["pack_units", "fused_bottleneck_chain",
           "fused_bottleneck_chain_reference", "fits", "takes_unit", "plan",
           "kernel_info"]

MAX_M = 1024
_SMS = 132                     # the H100's SMs
_RING = 3 * 192 * 64           # the weight ring: 3 stages of 192 64-byte rows
# The widest row K8 takes: one row's t1 and t2 within 219 KB.
_ROW_LIMIT = 232_448 - 8_192
# Dynamic shared memory a block may hold (t1, t2 and the ring); the second
# figure lets two blocks share an SM's 228 KB (1 KB each kept by the
# hardware).
_SMEM_ONE = 232_448
_SMEM_TWO = 233_472 // 2 - 1_024
# A pass's epilogue takes about as long as this many ring stages (K8 with
# and without its epilogues, on the H100 at ResNet-50's and WRN-50-2's
# chain shapes: 3.8-4.6 us against 0.7-0.9 us a stage).
_EPILOGUE_STAGES = 5


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


def _smem(th: int, tw: int, m: int) -> int:
    """Dynamic shared bytes of a block of ``th`` x ``tw`` output pixels: t1
    with its halo, t2 (channels padded to 64) and the weight ring."""
    mp = -(-m // 64) * 64
    return ((th + 2) * (tw + 2) + th * tw) * mp + _RING


def _splits(n: int) -> List[int]:
    """The even splits of ``n``: ``ceil(n / k)`` for k = 1 .. n."""
    return sorted({-(-n // k) for k in range(1, n + 1)})


def _block_cost(th: int, tw: int, h: int, w: int, c: int, m: int) -> int:
    """A block's time in ring stages: its stages, and its passes'
    epilogues at ``_EPILOGUE_STAGES`` each, with the kernel's pass shapes
    (``make_step`` in ``csrc/fused_bottleneck.cu``): 256 >> wsh pixels x
    32 << wsh channels, the widest the step's pixels fill."""
    stages = passes = 0
    for p, n, k, taps, first in ((min(th + 2, h) * min(tw + 2, w), m, c, 1,
                                  True),
                                 (th * tw, m, m, 9, False),
                                 (th * tw, c, m, 1, False)):
        wsh = 2 if p <= 64 else 1 if p <= 128 else 0
        if n <= 64:
            wsh = min(wsh, 1)
        if n <= 32:
            wsh = 0
        if first:
            wsh = max(wsh, 1)
        n_pass = -(-p // (256 >> wsh)) * -(-n // (32 << wsh))
        stages += n_pass * taps * -(-k // 64)
        passes += n_pass
    return stages + _EPILOGUE_STAGES * passes


def _plan_cost(b, h, w, c, m, th, tw) -> int:
    """A call's time under a plan, in ring stages: waves of blocks (two an
    SM where their shared memory fits; co-resident blocks run at about
    their own speed, as a block waits mostly on latency) times a block's
    time."""
    blocks = -(-h // th) * -(-w // tw) * b
    slots = _SMS * (2 if _smem(th, tw, m) <= _SMEM_TWO else 1)
    return -(-blocks // slots) * _block_cost(th, tw, h, w, c, m)


def plan(b: int, h: int, w: int, c: int, m: int):
    """(rows, columns) of a block's output tile for a unit of width ``c``,
    mid width ``m`` on ``b`` images of ``h`` x ``w``: whole rows,
    ``ceil(h / n)`` a tile, or where not one whole row fits beside the
    weight ring, one row in ``ceil(w / n)`` columns. Of the tiles whose
    shared memory fits, the one of least :func:`_plan_cost`, and of those
    the largest. Raises where one row is wider than K8 takes."""
    if -(-3 * (w + 2) * m // 16) * 16 + w * m > _ROW_LIMIT:
        raise ValueError(f"fused_bottleneck: one row of W {w} at M {m} "
                         f"needs more than the {_ROW_LIMIT} bytes of shared "
                         f"memory K8 gives a row")
    fit = [(t, w) for t in _splits(h) if _smem(t, w, m) <= _SMEM_ONE]
    if not fit:
        fit = [(1, t) for t in _splits(w) if _smem(1, t, m) <= _SMEM_ONE]
    return min(fit, key=lambda p: (_plan_cost(b, h, w, c, m, *p),
                                   -p[0] * p[1]))


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
    return _launch(xq, packed, plan(bsz, h, w, c, m))


def _launch(x: torch.Tensor, packed: Dict, tile) -> torch.Tensor:
    """The chain on the card, one launch a unit, in output tiles of ``tile``
    = (rows, columns) (checked operands; :func:`plan`'s tile, or another
    that fits for ``kernels/fused_bottleneck_plans.py``)."""
    th, tw = tile
    bsz, h, w, c = x.shape
    m = packed["w1"].shape[1]
    lib = library()
    for u, (q1, q2, q3) in enumerate(packed["q"]):
        out = torch.empty_like(x)
        args = [packed[k][u].data_ptr() for k in
                ("w1", "w2", "w3", "a1", "b1", "a2", "b2", "a3", "b3")]
        with torch.cuda.device(x.device):
            check(lib.pcv_fused_bottleneck(
                x.data_ptr(), *args, q1, q2, q3, packed["r"][u],
                out.data_ptr(), bsz, h, w, c, m, th, tw,
                _smem(th, tw, m), stream_of(x)), "fused_bottleneck")
        LAUNCHES["fused_bottleneck"] += 1
        x = out
    return x


def kernel_info(b: int, h: int, w: int, c: int, m: int) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of K8 on ``b`` images of (h, w, c) at mid width ``m``,
    with its plan's rows and columns a tile (needs the card)."""
    out = (ctypes.c_int * 3)()
    check(library().pcv_fused_bottleneck_info(c, m, out),
          "fused_bottleneck info")
    th, tw = plan(b, h, w, c, m)
    return dict(zip(("registers", "spill_bytes", "static_smem"), out),
                dynamic_smem=_smem(th, tw, m), rows=th, cols=tw)
