"""Depthwise conv + folded BatchNorm + activation (K6): the block
``conv(groups=C) -> BN -> activation`` of the depthwise families in one
pass (``csrc/dwconv.cu``). Counterpart of ``pytorchcv_tpu.kernels.dwconv``
(``dwconv2d_bn_act``), in the port's NCHW layout.

The arithmetic, kernel and plain version alike: the k*k products summed in
f32, row ``di`` outer and column ``dj`` inner, each product and sum rounded
on its own (for bf16 x and w a product is exact in f32, so the kernel
fuses it with its sum); then ``acc * scale`` and ``+ shift`` (two
roundings), the activation in f32, one cast to x's type. f32 results of
the two are bit-exact for the piecewise-linear activations; sigmoid and
swish differ by the kernel's fast ``exp`` (a few ulps), and for bf16
outputs the kernel takes the sigmoid as 0.5 + 0.5 tanh(y / 2) with the
hardware's tanh (within 2^-11, an eighth of a bf16 ulp).

The kernel stages a tile of whole output rows (several whole planes, or a
band of rows of one plane) in shared memory, zero-padded and, for stride
2, split by column parity; each thread computes strips of V outputs of one
row. :func:`dwconv_plan` picks V, the tile and the threads a block, and
:func:`tile_geometry` gives the shared layout (``layout`` in
``csrc/dwconv.cu`` checks it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ._build import (LAUNCHES, autograd_records, check, device_of, div6,
                     library, require_cuda_or_cpu, stream_of)

__all__ = ["ACTIVATIONS", "MODEL_ACTIVATIONS", "DwPlan", "dwconv2d_bn_act",
           "dwconv2d_bn_act_reference", "dwconv_plan", "tile_geometry",
           "kernel_info"]

_DTYPES = (torch.bfloat16, torch.float32)
_KSIZES = (3, 5, 7)


def _clip06(y):
    return y.clamp(0.0, 6.0)


# The activations of the TPU kernel (JAX ``kernels/dwconv.py:35-43``), in
# its order, which is also K6's code for each. ``hswish`` multiplies by
# 1/6 as there (the model's hswish divides by 6).
ACTIVATIONS = {
    "none": lambda y: y,
    "relu": lambda y: y.clamp_min(0.0),
    "relu6": _clip06,
    "hswish": lambda y: y * _clip06(y + 3.0) * (1.0 / 6.0),
    "hsigmoid": lambda y: _clip06(y + 3.0) * (1.0 / 6.0),
    "swish": lambda y: y * torch.sigmoid(y),
    "sigmoid": torch.sigmoid,
}


# K6's codes past the TPU kernel's: "hswish_div" is the model's hswish
# (JAX ``nn/activ.py:35``, ``nn.activ.HSwish``), ``y * clip(y + 3, 0, 6) /
# 6``, the product first, then a division by 6 (bit-exact in f32 against
# the unfused block, where "hswish" is not).
MODEL_ACTIVATIONS = {
    "hswish_div": lambda y: div6(y * _clip06(y + 3.0)),
}
_ALL_ACTS = {**ACTIVATIONS, **MODEL_ACTIVATIONS}
_ACT_CODES = {name: i for i, name in enumerate(_ALL_ACTS)}

Pad = Tuple[Tuple[int, int], Tuple[int, int]]


class DwPlan(NamedTuple):
    """A K6 launch: ``v`` outputs a thread's strip, ``planes`` whole planes
    a tile (``rows`` == Ho) or bands of ``rows`` output rows of one plane
    (``planes`` == 1), ``threads`` threads a block."""
    v: int
    planes: int
    rows: int
    threads: int


class Geometry(NamedTuple):
    """A tile's shared layout in f32 words: ``rows_in`` staged rows a
    plane of ``row_pitch`` words (stride 2: ``half`` even columns, then
    ``half`` odd ones), planes ``plane_pitch`` apart; the weights from
    ``w_off``; from byte ``out_off`` the tile's input span as it lies,
    which the staged outputs overwrite; ``smem`` bytes in all."""
    spr: int
    rows_in: int
    row_pitch: int
    half: int
    plane_pitch: int
    w_off: int
    out_off: int
    smem: int


# Strip widths (csrc/dwconv.cu instances): 4 for 16-byte shared loads, 7
# for rows of 7, 14 and 28. Strips of 8 spilled at k 5 (8 bytes).
_VS = (4, 7)
_MAX_THREADS = 256
_SMS = 132                 # the H100's SMs
_SM_THREADS = 2048
_SM_SMEM = 233_472         # shared bytes an SM; 1 KB of it held per block
_SMEM_BLOCK = 232_448      # dynamic shared memory a block may hold
_MAX_ROUNDS = 4            # strips a thread in a tile, at most
# Registers a thread of each strip width (the card's kernel_info; they
# bound the blocks an SM holds).
_REGS = {4: 64, 7: 64}
# A tile's cost in issue slots a thread: an input element's copy and
# layout, a strip's fixed work, an output's epilogue (affine, swish), the
# tile's barriers and weight loads. A tile's chain of dependent steps also
# waits _LATENCY cycles and _BYTE_CYCLES a byte of its input span (an SM's
# share of the memory rate), which the other blocks an SM holds hide. All
# fitted to the sweep of kernels/dwconv_plans.py on the H100 (NVIDIA H100
# 80GB HBM3, 700 W): over EfficientNet-B0's 16 calls the plans' sum lies
# within 2-4 % of the sum of each call's fastest alternative measured.
_ELEM = 24
_STRIP, _EPI = 12, 30
_FIXED = 100
_LATENCY = 5000
_BYTE_CYCLES = 0.07


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _out_size(size: int, k: int, stride: int, lo: int, hi: int) -> int:
    return (size + lo + hi - k) // stride + 1


def _layout(h: int, w: int, ho: int, wo: int, k: int, stride: int, v: int,
            planes: int, rows: int, esize: int, row_pitch: int, half: int,
            plane_pitch: int) -> Geometry:
    """The layout under the given pitches (``layout`` in
    ``csrc/dwconv.cu``): the planes, their weights, then the input span as
    it lies (the 16-byte vectors around it), which the staged outputs
    overwrite."""
    rows_in = (rows - 1) * stride + k
    span = planes * h * w if rows == ho else min(rows_in, h) * w
    w_off = planes * plane_pitch
    out_off = _round_up(4 * (w_off + planes * (k * k + 2)), 16)
    return Geometry(-(-wo // v), rows_in, row_pitch, half, plane_pitch,
                    w_off, out_off,
                    out_off + max(_round_up(span * esize + 15, 16),
                                  planes * rows * wo * esize + 16))


def _min_pitches(wo: int, k: int, stride: int, v: int, rows: int):
    """The least (row_pitch, half, plane_pitch) that hold the strips'
    reach: rows of whole strips plus k - 1 columns (stride 2: each parity
    half), 16-byte aligned where ``v % 4 == 0``."""
    spr = -(-wo // v)
    al = 4 if v % 4 == 0 else 1
    if stride == 1:
        half, row_pitch = 0, _round_up(spr * v + k - 1, al)
    else:
        half = _round_up(spr * v + (k - 1) // 2, al)
        row_pitch = 2 * half
    rows_in = (rows - 1) * stride + k
    return row_pitch, half, _round_up(rows_in * row_pitch, al)


def _bank_cost(spr: int, v: int, stride: int, rows: int, strips: int,
               row_pitch: int, plane_pitch: int) -> int:
    """Shared-memory wavefronts of one load of a block's first 256 strips:
    16-byte loads (``v % 4 == 0``) in phases of 8 lanes over 8 bank
    groups, else 4-byte loads of 32 lanes over 32 banks; a phase costs the
    most lanes that meet in one group or bank."""
    i = np.arange(min(strips, _MAX_THREADS))
    per_plane = rows * spr
    pl, rem = i // per_plane, i % per_plane
    base = (pl * plane_pitch + (rem // spr) * stride * row_pitch +
            (rem % spr) * v)
    if v % 4 == 0:
        lanes, bank = 8, (base // 4) % 8
    else:
        lanes, bank = 32, base % 32
    bank = np.pad(bank, (0, -len(bank) % lanes), constant_values=-1)
    return sum(int(np.bincount(b[b >= 0]).max())
               for b in bank.reshape(-1, lanes) if (b >= 0).any())


@functools.lru_cache(maxsize=4096)
def tile_geometry(h: int, w: int, ho: int, wo: int, k: int, stride: int,
                  v: int, planes: int, rows: int, esize: int) -> Geometry:
    """The shared layout of a tile of ``planes`` x ``rows`` output rows of
    an (h, w) -> (ho, wo) map, strips of ``v``, elements of ``esize``
    bytes: of the row pitch up to one bank period above the least
    (:func:`_min_pitches`), then the plane pitch, those whose strips'
    loads meet the fewest bank conflicts (:func:`_bank_cost`), then the
    smallest. The kernel takes them as they are (``layout`` in
    ``csrc/dwconv.cu`` checks them)."""
    rp0, half0, pp0 = _min_pitches(wo, k, stride, v, rows)
    spr = -(-wo // v)
    rows_in = (rows - 1) * stride + k
    unit = 4 if v % 4 == 0 else 1
    strips = planes * rows * spr

    def key(rp, pp):
        g = _layout(h, w, ho, wo, k, stride, v, planes, rows, esize, rp,
                    rp // 2 if stride == 2 else 0, pp)
        return (_bank_cost(spr, v, stride, rows, strips, rp, pp), g.smem), g
    # the row pitch first (at the least plane pitch it allows), then the
    # plane pitch; a bank period of 32 words above the least of each
    best = None
    for d in range(0, 32, unit):
        rp = 2 * (half0 + d) if stride == 2 else rp0 + d
        cand = key(rp, _round_up(rows_in * rp, unit))
        if cand[1].smem <= _SMEM_BLOCK and (best is None or
                                            cand[0] < best[0]):
            best = cand
    if best is None:
        return _layout(h, w, ho, wo, k, stride, v, planes, rows, esize, rp0,
                       half0, pp0)
    rp = best[1].row_pitch
    if planes > 1:
        for e in range(unit, 32, unit):
            cand = key(rp, _round_up(rows_in * rp, unit) + e)
            if cand[1].smem <= _SMEM_BLOCK and cand[0] < best[0]:
                best = cand
    return best[1]


def _strip_loads(v: int, k: int, stride: int) -> int:
    """Shared loads of a strip: per kernel row its inputs, four to a load
    where ``v % 4 == 0`` (then a pair and a single for the rest)."""
    def row(n):
        return n // 4 + (n % 4) // 2 + (n % 2) if v % 4 == 0 else n
    if stride == 1:
        return k * row(v + k - 1)
    return k * (row(v + (k - 1) // 2) + row(v + (k - 3) // 2))


def _plan_cost(n_planes: int, h: int, w: int, ho: int, wo: int, k: int,
               stride: int, esize: int, plan: DwPlan) -> float:
    """A call's time in cycles of one SM: the larger of its tiles' issue
    slots over the four schedulers and its tiles' chains (latency, the
    span's bytes, the tile's own issue) over the blocks the SM holds at
    once (threads, shared memory and registers allowing)."""
    v, planes, rows, threads = plan
    g = _layout(h, w, ho, wo, k, stride, v, planes, rows, esize,
                *_min_pitches(wo, k, stride, v, rows))
    if rows == ho:
        tiles = -(-n_planes // planes)
        span = planes * h * w
    else:
        tiles = n_planes * -(-ho // rows)
        span = min(g.rows_in, h) * w
    taps = k * k * (1 if esize == 2 else 2)     # bf16 products fuse
    instr = (-(-span // threads) * _ELEM
             + -(-(planes * rows * g.spr) // threads)
             * (v * (taps + _EPI) + _strip_loads(v, k, stride) + _STRIP)
             + _FIXED)
    per_sm = max(1, min(_SM_THREADS // threads, 32,
                        _SM_SMEM // (g.smem + 1024),
                        65536 // (threads * _REGS[v])))
    tiles_sm = -(-tiles // (_SMS * per_sm)) * per_sm
    tile_issue = threads // 32 * instr / 4
    chain = _LATENCY + span * esize * _BYTE_CYCLES + tile_issue
    return max(tiles_sm * tile_issue, tiles_sm * chain / per_sm)


def _candidates(h: int, w: int, ho: int, wo: int, k: int, stride: int,
                esize: int):
    for v in _VS:
        spr = -(-wo // v)
        per_plane = ho * spr
        for planes in range(1, _MAX_ROUNDS * _MAX_THREADS // per_plane + 1):
            if _layout(h, w, ho, wo, k, stride, v, planes, ho, esize,
                       *_min_pitches(wo, k, stride, v, ho)
                       ).smem <= _SMEM_BLOCK:
                yield DwPlan(v, planes, ho, min(_MAX_THREADS, _round_up(
                    planes * per_plane, 32)))
        for rows in range(1, min(ho, _MAX_ROUNDS * _MAX_THREADS // spr + 1)):
            if _layout(h, w, ho, wo, k, stride, v, 1, rows, esize,
                       *_min_pitches(wo, k, stride, v, rows)
                       ).smem <= _SMEM_BLOCK:
                yield DwPlan(v, 1, rows, min(_MAX_THREADS, _round_up(
                    rows * spr, 32)))


@functools.lru_cache(maxsize=1024)
def dwconv_plan(n: int, c: int, h: int, w: int, k: int, stride: int,
                pad: Pad, dtype: torch.dtype) -> DwPlan:
    """K6's launch for x (n, c, h, w) of ``dtype`` under a k x k kernel,
    ``stride`` and ``pad``: of the strip widths, tiles (whole planes up to
    ``_MAX_ROUNDS`` strips a thread, or bands of rows) and blocks of up to
    256 threads whose shared memory fits, the least :func:`_plan_cost`;
    of equals the fewest blocks. Cached per shape: the wrapper asks on
    every call."""
    (top, bottom), (left, right) = pad
    ho = _out_size(h, k, stride, top, bottom)
    wo = _out_size(w, k, stride, left, right)
    esize = 2 if dtype == torch.bfloat16 else 4
    best = None
    for plan in _candidates(h, w, ho, wo, k, stride, esize):
        tiles = (-(-(n * c) // plan.planes) if plan.rows == ho
                 else n * c * -(-ho // plan.rows))
        key = (_plan_cost(n * c, h, w, ho, wo, k, stride, esize, plan),
               tiles)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"dwconv: a row {wo} wide leaves no room for one "
                         f"row's tile in shared memory")
    return best[1]


def dwconv2d_bn_act_reference(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor, shift: torch.Tensor,
                              stride: int, pad: Pad,
                              act: str) -> torch.Tensor:
    """Plain PyTorch version of K6, in its order: a loop over the taps on
    f32 tensors (not ``F.conv2d``), then the epilogue."""
    k = w.shape[-1]
    (top, bottom), (left, right) = pad
    _, c, h, wd = x.shape
    ho = _out_size(h, k, stride, top, bottom)
    wo = _out_size(wd, k, stride, left, right)
    xp = F.pad(x.to(torch.float32), (left, right, top, bottom))
    w_taps = w.to(torch.float32).reshape(c, k * k).t().reshape(
        k * k, 1, c, 1, 1)
    acc = None
    for t in range(k * k):
        di, dj = divmod(t, k)        # row outer, column inner
        prod = xp[:, :, di:di + stride * (ho - 1) + 1:stride,
                  dj:dj + stride * (wo - 1) + 1:stride] * w_taps[t]
        acc = prod if acc is None else acc + prod
    y = acc * scale.view(1, c, 1, 1) + shift.view(1, c, 1, 1)
    return _ALL_ACTS[act](y).to(x.dtype)


def dwconv2d_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, stride: int = 1,
                    pad: Pad = ((1, 1), (1, 1)),
                    act: str = "relu") -> torch.Tensor:
    """K6: ``x`` contiguous (N, C, H, W) f32 or bf16; ``w`` (C, 1, k, k) in
    x's type with k in (3, 5, 7), as the depthwise conv stores it;
    ``scale``, ``shift`` f32 (C,), the folded BN; ``stride`` 1 or 2;
    ``pad`` ((top, bottom), (left, right)) zeros; ``act`` one of
    :data:`ACTIVATIONS` or :data:`MODEL_ACTIVATIONS`. Returns (N, C, Ho,
    Wo) in x's type.

    Anything else raises, a call that autograd would record included (K6
    has no backward yet). CUDA tensors run the kernel, CPU tensors the
    plain version."""
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"dwconv: x must be contiguous (N, C, H, W) of "
                         f"{_DTYPES}, got {tuple(x.shape)} {x.dtype}"
                         f"{'' if x.is_contiguous() else ', not contiguous'}")
    n, c, h, wd = x.shape
    k = w.shape[-1] if w.dim() == 4 else None
    if (w.dim() != 4 or tuple(w.shape) != (c, 1, k, k) or k not in _KSIZES
            or w.dtype != x.dtype or not w.is_contiguous()):
        raise ValueError(f"dwconv: w must be contiguous ({c}, 1, k, k) in "
                         f"{x.dtype} with k in {_KSIZES}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) or \
                not v.is_contiguous():
            raise ValueError(f"dwconv: {name} must be contiguous f32 "
                             f"({c},), got {tuple(v.shape)} {v.dtype}")
    if stride not in (1, 2):
        raise ValueError(f"dwconv: stride must be 1 or 2, got {stride}")
    (top, bottom), (left, right) = pad
    if min(top, bottom, left, right) < 0:
        raise ValueError(f"dwconv: negative padding {pad}")
    if act not in _ALL_ACTS:
        raise ValueError(f"dwconv: act must be one of {list(_ALL_ACTS)}, "
                         f"got {act!r}")
    ho = _out_size(h, k, stride, top, bottom)
    wo = _out_size(wd, k, stride, left, right)
    if ho < 1 or wo < 1:
        raise ValueError(f"dwconv: empty output for x {tuple(x.shape)}, "
                         f"k {k}, stride {stride}, pad {pad}")
    if autograd_records(x, w, scale, shift):
        raise ValueError("dwconv: K6 has no backward; call it under "
                         "torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("dwconv", x, w, scale, shift):
        return dwconv2d_bn_act_reference(x, w, scale, shift, stride, pad,
                                         act)
    if max(x.numel(), n * c * ho * wo) >= 2 ** 31:
        raise ValueError(f"dwconv: x {tuple(x.shape)} or its output "
                         f"exceeds the kernel's index range")
    pad = ((top, bottom), (left, right))
    return _launch(x, w, scale, shift, stride, pad, act,
                   dwconv_plan(n, c, h, wd, k, stride, pad, x.dtype))


def _launch(x, w, scale, shift, stride, pad, act, plan: DwPlan):
    """K6 on the card under ``plan`` (checked operands; the plan's, or
    another for the plans tool and the card tests)."""
    n, c, h, wd = x.shape
    k = w.shape[-1]
    (top, bottom), (left, right) = pad
    ho = _out_size(h, k, stride, top, bottom)
    wo = _out_size(wd, k, stride, left, right)
    g = tile_geometry(h, wd, ho, wo, k, stride, plan.v, plan.planes,
                      plan.rows, x.element_size())
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    with device_of(x):
        check(library().pcv_dwconv(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), n, c, h, wd, ho, wo, k, stride, top, left,
            _ACT_CODES[act], int(x.dtype == torch.bfloat16), plan.v,
            plan.planes, plan.rows, plan.threads, g.row_pitch, g.half,
            g.plane_pitch, stream_of(x)), "dwconv")
    LAUNCHES["dwconv"] += 1
    return out


def kernel_info(n: int, c: int, h: int, w: int, k: int, stride: int,
                pad: Pad, dtype: torch.dtype) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of K6 on x (n, c, h, w) of ``dtype``, with the plan it
    runs under (needs the card)."""
    plan = dwconv_plan(n, c, h, w, k, stride, pad, dtype)
    (top, bottom), (left, right) = pad
    ho = _out_size(h, k, stride, top, bottom)
    wo = _out_size(w, k, stride, left, right)
    es = 2 if dtype == torch.bfloat16 else 4
    g = tile_geometry(h, w, ho, wo, k, stride, plan.v, plan.planes,
                      plan.rows, es)
    out = (ctypes.c_int * 4)()
    check(library().pcv_dwconv_info(k, stride, plan.v, int(es == 2), h, w,
                                    ho, wo, plan.planes, plan.rows,
                                    g.row_pitch, g.half, g.plane_pitch, out),
          "dwconv info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out), plan=plan)
