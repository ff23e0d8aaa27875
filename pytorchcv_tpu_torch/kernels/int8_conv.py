"""int8 NHWC convolution with the serving pipeline's fused epilogue (K2).

One call is one int8 conv of the int8 ResNet pipeline, with its epilogue:

* ``q`` given, no residual: ``clip(rint(act(acc*A + B) * q), +-127)`` int8
  (``_cell`` with ``s_out``);
* no ``q``, no residual: ``act(acc*A + B)`` as bf16 (``_cell`` without
  ``s_out``);
* residual given (the unit tail): ``t = bf16(acc*A + B)``, ``r`` the
  residual term, ``y = max(t + r, 0)``, int8 via ``q`` or bf16 without it.
  An int8 residual enters as ``f32(res) * res_scale``, rounded to bf16 when
  ``round_res``; a bf16 residual enters as it is;
* ``linear_res`` (MobileNetV2's project conv, JAX
  ``quant/mobilenet_int8.py:145-149``): ``y = (acc*A + B) + f32(res) *
  res_scale`` in f32, no bf16 rounding and no activation, then int8 via
  ``q``.

``act`` is ``"relu"`` (``max(y, 0)``), ``"relu6"`` (``clip(y, 0, 6)``,
MobileNetV2's ``_cell6``) or None; the residual tails take the max as
above. ``out_f32`` writes f32 instead of bf16 where there is no ``q`` (the
MobileNet final blocks, whose mean the head takes in f32).

With ``bend`` the call also returns the bf16 value of ``y`` before the
int8 requantization (the stage-3 tap of the segmentation backbone), written
in the same launch. ``dilation`` spreads the taps (pad ``dilation * (k //
2)``).

``acc`` is the exact int32 sum, ``A`` and ``B`` are f32 per output channel
and every step follows the JAX reference's f32 op order, so the kernel
(``csrc/int8_conv.cu``, an implicit GEMM on the int8 tensor cores) and the
plain version are bit-exact against it.

The kernel computes an output tile of BM pixels x BN channels a block;
:func:`plan` picks the tile per conv from :data:`TILES` (the least
:func:`plan_cost`, a cost in estimated clocks) and :func:`block_tile` maps
a block to its tile as the kernel does.

A grouped conv (``groups > 1``, ``w`` of shape (Cout, k, k, Cin / groups):
ResNeXt's and SENet's grouped 3x3) runs the grouped kernel
(``csrc/int8_gconv.cu``, the same epilogue): an implicit GEMM on the int8
tensor cores over block-diagonal tiles. A block owns a channel tile and
walks spatial tiles, each with its input halo in shared memory, one slab
per channel window (window-major); every n8 tile of output channels meets
only its groups' window, packed (tap, 8-byte piece) into k32 chunks.
:func:`gconv_plan` picks the block tile and the spatial tile per conv
(:func:`gconv_cost`), and
:func:`gconv_tables` builds a block's B fragments and halo offsets as the
kernel does (the CPU emulation test reads it). Per-group input widths
:data:`GROUP_WIDTHS`; the output width per group a multiple of 2. The
plain version is ``F.conv2d(..., groups=)`` in float64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ._build import (ACTS_I8, LAUNCHES, act_code_i8, activate_i8_reference,
                     check, device_of, library, require_cuda_or_cpu,
                     stream_of)

__all__ = ["int8_conv", "int8_conv_reference", "plan", "plan_cost",
           "block_tile", "blocks", "smem_bytes", "kernel_info",
           "instance_info", "TILES", "GROUP_WIDTHS", "GCONV_TILES",
           "GPlan", "gconv_plan", "gconv_tile", "gconv_cost",
           "gconv_window", "gconv_spatial_tiles", "gconv_tables",
           "gconv_issued_ops", "gconv_info"]

_RES_NONE, _RES_I8, _RES_I8_BF16, _RES_BF16, _RES_F32 = 0, 1, 2, 3, 4
_OUT_BF16, _OUT_I8, _OUT_F32 = 0, 1, 2

# Block tiles (output pixels, output channels) the kernel is built for.
TILES: Tuple[Tuple[int, int], ...] = ((128, 128), (128, 64), (64, 128),
                                      (64, 64))
_SMS = 132                     # the H100's SMs
_STAGES, _KS = 4, 64           # the ring: 4 stages of 64 K bytes
# The cost model's clocks (an estimate for the H100, relative): a ring
# stage takes its products (_MMA_CLK a m16n8k32 mma on each of the 4 warp
# schedulers) or its copies (_COPY_BYTES_CLK bytes a clock from L2),
# whichever is more, plus _FIXED (barrier, exposed latency); a tile's
# epilogue _EPI_CLK per 128 x 128 outputs plus _FIXED.
_MMA_CLK = 6
_COPY_BYTES_CLK = 48
_FIXED = 100
_EPI_CLK = 2000


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared bytes of a ``bm`` x ``bn`` block: the 4-stage ring of
    (bm + bn) 64-byte rows, or over it the epilogue's int32 tile (rows
    padded by 8 words), then A and B per channel (``smem_bytes`` in
    ``csrc/int8_conv.cu``)."""
    return max(_STAGES * (bm + bn) * _KS, bm * (bn + 8) * 4) + 8 * bn


def plan_cost(m: int, cout: int, cin: int, k: int, bm: int, bn: int) -> float:
    """A conv's time under tile ``bm`` x ``bn`` in estimated clocks: the
    blocks an SM runs in turn (the grid over 132 SMs) times a block's ring
    stages and epilogue (the ``_MMA_CLK`` ... ``_EPI_CLK`` model)."""
    blocks = -(-m // bm) * -(-cout // bn)
    steps = k * k * -(-cin // _KS)
    stage = max(_MMA_CLK * bm * bn / 256,
                (bm + bn) * _KS / _COPY_BYTES_CLK) + _FIXED
    epilogue = _EPI_CLK * bm * bn / (128 * 128) + _FIXED
    return -(-blocks // _SMS) * (steps * stage + epilogue)


@functools.lru_cache(maxsize=1024)
def plan(m: int, cout: int, cin: int, k: int) -> Tuple[int, int]:
    """(BM, BN) for a conv of ``m`` output pixels (batch x Ho x Wo), ``cout``
    output channels, ``cin`` input channels and a ``k`` x ``k`` kernel: the
    tile of :data:`TILES` with the least :func:`plan_cost`, and of those
    the largest. Cached: the wrapper asks once a call."""
    return min(TILES, key=lambda t: (plan_cost(m, cout, cin, k, *t),
                                     -t[0] * t[1]))


def block_tile(m: int, cout: int, tile: Tuple[int, int],
               block: int) -> Tuple[int, int]:
    """(first pixel, first channel) of block ``block`` under ``tile``, as
    the kernel maps ``blockIdx.x`` (channel tiles of one pixel tile are
    neighbours, so they read its activations from L2)."""
    bm, bn = tile
    n_tiles = -(-cout // bn)
    return block // n_tiles * bm, block % n_tiles * bn


def blocks(m: int, cout: int, tile: Tuple[int, int]) -> int:
    """The grid of a conv under ``tile``."""
    return -(-m // tile[0]) * -(-cout // tile[1])


# Per-group input widths the grouped kernel is built for (those of every
# ResNeXt, SE-ResNeXt and SENet of the zoo).
GROUP_WIDTHS = (2, 4, 8, 16, 32)
# Block tiles (pixel rows, output channels) of the grouped kernel.
GCONV_TILES: Tuple[Tuple[int, int], ...] = ((128, 128), (128, 64), (64, 128),
                                            (64, 64))
_SMEM_MAX = 227 * 1024         # dynamic shared bytes a block may take
_SMEM_SM = 228 * 1024          # an SM's shared memory (1 KB a block reserved)
# The grouped cost model's clocks (an estimate for the H100, relative): a
# 128-byte wavefront of A's shared loads (_LDS_CLK; two 64-bit loads, four
# wavefronts, an m16 tile) and a m16n8k32 mma (_GMMA_CLK) per SM,
# the halo's bytes from L2 (_HALO_BYTES_CLK a clock per SM), the epilogue
# per 128 x 128 outputs (_EPI_CLK) and _FIXED per spatial tile; a second
# block on an SM hides a share _OVERLAP of the first's time.
_LDS_CLK = 1.0
_GMMA_CLK = 0.5
_HALO_BYTES_CLK = 32
_OVERLAP = 0.35


class GPlan(NamedTuple):
    """A grouped conv's plan: block tile ``bm`` pixel rows x ``bn`` output
    channels, runs of ``u`` n8 tiles sharing a window, spatial tile
    ``imgs`` images x ``th`` output rows x ``tw`` columns, the halo's copy
    width ``vec`` bytes, ``wb`` window bytes a pixel (each n8 tile's input
    channels from its run's first group, down to a multiple of 4), ``ch``
    k32 chunks, the halo's ``hr`` x ``hc`` pixels an image, a slab's stride
    ``slab`` bytes, the dynamic shared bytes ``smem`` and the blocks an SM
    holds by it."""
    bm: int
    bn: int
    u: int
    imgs: int
    th: int
    tw: int
    vec: int
    wb: int
    ch: int
    hr: int
    hc: int
    slab: int
    smem: int
    per_sm: int


def _out_hw(h: int, w: int, k: int, stride: int, dilation: int):
    pad = dilation * (k // 2)
    return ((h + 2 * pad - dilation * (k - 1) - 1) // stride + 1,
            (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1)


def gconv_window(n0: int, nj: int, cout: int, groups: int, cin: int,
                 u: int) -> Tuple[int, int]:
    """(lo, hi) of n8 tile ``nj`` (its first output channel) in the block
    of channel tile ``n0`` under runs of ``u`` tiles: its run's window
    starts at the run's first group's channel, down to a multiple of 4
    (``lo``); the tile's groups end at channel ``hi`` (the window check in
    ``csrc/int8_gconv.cu``)."""
    cg, og = cin // groups, cout // groups
    run = n0 + (nj - n0) // (8 * u) * 8 * u
    return run // og * cg & ~3, ((min(nj + 8, cout) - 1) // og + 1) * cg


def slab_bytes(pixels: int, wb: int) -> int:
    """A halo slab's stride (``slab_bytes`` in ``csrc/int8_gconv.cu``):
    ``pixels`` windows of ``wb`` bytes, padded to 16 bytes past a multiple
    of 128."""
    return (pixels * wb + 111) // 128 * 128 + 16


@functools.lru_cache(maxsize=1024)
def gconv_tile(bsz: int, h: int, w: int, cin: int, cout: int, groups: int,
               k: int, stride: int, dilation: int, bm: int,
               bn: int) -> Optional[GPlan]:
    """The plan of a grouped conv under block tile ``bm`` x ``bn``, or None
    where its shared memory exceeds a block's. The spatial tile is whole
    images where one fits ``bm`` pixels, else whole rows, else a part of a
    row; n8 tiles of one group share A (og a multiple of 8 u); the window
    is the widest any n8 tile needs, in 8-byte pieces, copied in the widest
    of 16, 8 and 4 bytes every window start and Cin allow (bytes where Cin
    is not a multiple of 4). Cached: a forced tile's launch asks on every
    call."""
    ho, wo = _out_hw(h, w, k, stride, dilation)
    cg, og = cin // groups, cout // groups
    tw = min(wo, bm)
    th = min(ho, bm // tw)
    imgs = min(bsz, bm // (th * tw)) if th == ho and tw == wo else 1
    u = next(u for u in (4, 2, 1)
             if u == 1 or (og % (8 * u) == 0 and bn % og == 0))
    los, need = set(), 8
    for n0 in range(0, cout, bn):
        for nj in range(n0, min(n0 + bn, cout), 8):
            lo, hi = gconv_window(n0, nj, cout, groups, cin, u)
            los.add(lo)
            need = max(need, hi - lo)
    wb = -(-need // 8) * 8
    vec = 1 if cin % 4 else next(
        v for v in (16, 8, 4)
        if wb % v == 0 and cin % v == 0 and all(lo % v == 0 for lo in los))
    group = bn // 8 // u * (wb // vec)
    ch = -(-k * k * (wb // 8) // 4)
    hr = (th - 1) * stride + (k - 1) * dilation + 1
    hc = (tw - 1) * stride + (k - 1) * dilation + 1
    slab = slab_bytes(imgs * hr * hc, wb)
    # the weight rows with each piece's tap and each output's group
    rows = -(-bn * k * k * cg // 16) * 16 + 32 * ch + 4 * bn
    region = -(-max(bn // 8 // u * slab, rows, bm * (bn + 8) * 4) // 16) * 16
    smem = bn * ch * 34 + region + 8 * bn + 16 * bm
    if smem > _SMEM_MAX or group > 256 or 256 % group or wb > 2040:
        return None
    per_sm = min(2, _SMEM_SM // (smem + 1024))
    return GPlan(bm, bn, u, imgs, th, tw, vec, wb, ch, hr, hc, slab, smem,
                 per_sm)


def gconv_spatial_tiles(bsz: int, ho: int, wo: int,
                        plan: GPlan) -> Tuple[int, int, int]:
    """(image tiles, row tiles, column tiles) of a grouped conv's output."""
    return (-(-bsz // plan.imgs), -(-ho // plan.th), -(-wo // plan.tw))


def gconv_cost(bsz: int, h: int, w: int, cin: int, cout: int, groups: int,
               k: int, stride: int, dilation: int, plan: GPlan) -> float:
    """A grouped conv's time under ``plan`` in estimated clocks: its
    (spatial tile, channel tile) pairs over 132 SMs, each the products
    (A's two 64-bit shared loads a run and the mma of its valid m16
    tiles), the halo's bytes and the epilogue, the second block of an SM
    hiding ``_OVERLAP`` of it (the ``_LDS_CLK`` ... ``_OVERLAP`` model)."""
    ho, wo = _out_hw(h, w, k, stride, dilation)
    it, rt, ct = gconv_spatial_tiles(bsz, ho, wo, plan)
    n_tiles = it * rt * ct * -(-cout // plan.bn)
    m16 = min(plan.bm // 16, -(-plan.imgs * plan.th * plan.tw // 16))
    n8 = plan.bn // 8
    prod = m16 * n8 * plan.ch * (_LDS_CLK * 4 / plan.u + _GMMA_CLK)
    halo = (n8 // plan.u * plan.imgs * plan.hr * plan.hc * plan.wb
            / _HALO_BYTES_CLK)
    epi = _EPI_CLK * plan.bm * plan.bn / (128 * 128)
    tile = prod + halo + epi + _FIXED
    if plan.per_sm > 1:
        tile *= 1.0 - _OVERLAP
    return -(-n_tiles // _SMS) * tile


def gconv_issued_ops(bsz: int, h: int, w: int, cin: int, cout: int,
                     groups: int, k: int, stride: int, dilation: int,
                     plan: GPlan) -> int:
    """The int8 tensor-core operations (2 a multiply-add) the grouped
    kernel issues under ``plan``: every m16 tile it runs (a spatial tile's
    rows rounded up to 16) x every column of its channel tiles x 32 k a
    chunk, the zeros off the groups' diagonal and of the padding
    included."""
    ho, wo = _out_hw(h, w, k, stride, dilation)
    it, rt, ct = gconv_spatial_tiles(bsz, ho, wo, plan)
    rows = min(plan.bm, -(-plan.imgs * plan.th * plan.tw // 16) * 16)
    return (2 * it * rt * ct * rows * -(-cout // plan.bn) * plan.bn * 32
            * plan.ch)


@functools.lru_cache(maxsize=1024)
def gconv_plan(bsz: int, h: int, w: int, cin: int, cout: int, groups: int,
               k: int, stride: int, dilation: int) -> GPlan:
    """The plan of a grouped conv of a (bsz, h, w, cin) input: of
    :data:`GCONV_TILES`, the tile with the least :func:`gconv_cost`, and of
    those the largest. Cached: the wrapper asks once a call."""
    plans = [p for p in (gconv_tile(bsz, h, w, cin, cout, groups, k, stride,
                                    dilation, *t) for t in GCONV_TILES) if p]
    if not plans:
        raise ValueError(f"int8_conv: no grouped tile fits shared memory at "
                         f"x {(bsz, h, w, cin)}, cout {cout}, k {k}")
    return min(plans, key=lambda p: (gconv_cost(
        bsz, h, w, cin, cout, groups, k, stride, dilation, p),
        -p.bm * p.bn))


def gconv_tables(w: torch.Tensor, groups: int, cin: int, n0: int,
                 plan: GPlan, k: int, dilation: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tables a block of channel tile ``n0`` builds from ``w`` (Cout,
    k, k, cg), as the kernel builds them. Piece t of k32 chunk c of n8 tile
    j (lane t's two A and B words) is piece P = 4 c + t of the tile's K
    sequence: tap P // (wb / 8), 8 bytes from 8 (P % (wb / 8)) of its run's
    window. Returns its byte offset from a row's halo pixel in the run's
    slab, (bn / 8, ch, 4) int64; and B, (bn / 8, ch, 4, 2, 4, 8) int64: byte
    b of word h of piece t for the tile's column g, zero off g's group, on
    the padding pieces past k*k taps and past Cout."""
    cout = w.shape[0]
    cg, og = cin // groups, cout // groups
    nb, ch, ppt = plan.bn // 8, plan.ch, plan.wb // 8
    j = torch.arange(nb)[:, None, None]
    piece = torch.arange(ch)[None, :, None] * 4 + torch.arange(4)
    nj = n0 + 8 * j
    jr = j // plan.u
    lo = torch.tensor([gconv_window(n0, min(int(v), cout - 1), cout, groups,
                                    cin, plan.u)[0] if v < cout else 0
                       for v in nj.flatten()]).reshape(nj.shape)
    tap, half = piece // ppt, piece % ppt
    pad = tap >= k * k
    off = jr * plan.slab + torch.where(
        pad, 0, (tap // k * plan.hc + tap % k) * dilation * plan.wb
        + 8 * half)
    # B: channel lo + 8 half + 4 h + b of output n = nj + g
    n = nj[..., None, None, None] + torch.arange(8)       # (nb,1,1,1,1,8)
    chan = (lo + 8 * half)[..., None, None, None] + (
        4 * torch.arange(2)[:, None, None] + torch.arange(4)[:, None])
    cl = chan - n // og * cg
    ok = (~pad[..., None, None, None]) & (n < cout) & (cl >= 0) & (cl < cg)
    wq = w.to(torch.int64).reshape(cout, k * k, cg)
    val = wq[n.clamp(max=cout - 1),
             tap.clamp(max=k * k - 1)[..., None, None, None],
             cl.clamp(0, cg - 1)]
    return off, torch.where(ok, val, 0)


def _quant_i8(y: torch.Tensor, q: float) -> torch.Tensor:
    return torch.clamp(torch.round(y * q), -127.0, 127.0).to(torch.int8)


def int8_conv_reference(x: torch.Tensor, w: torch.Tensor, gain_a: torch.Tensor,
                        bias_b: torch.Tensor, stride: int = 1,
                        act: Optional[str] = "relu",
                        q: Optional[float] = None,
                        residual: Optional[torch.Tensor] = None,
                        res_scale: Optional[float] = None,
                        round_res: bool = False, dilation: int = 1,
                        bend: bool = False, groups: int = 1,
                        linear_res: bool = False, out_f32: bool = False
                        ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain PyTorch version of K2. The conv runs in float64, which is exact
    (int8 sums stay far below 2**53; float32 is not: they pass 2**24)."""
    k = w.shape[1]
    acc = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                   w.permute(0, 3, 1, 2).to(torch.float64),
                   stride=stride, padding=dilation * (k // 2),
                   dilation=dilation, groups=groups)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()
    y = acc.to(torch.float32) * gain_a + bias_b
    if residual is None:
        return _outputs(activate_i8_reference(y, act), q, bend, out_f32)
    if linear_res:
        return _outputs(y + residual.to(torch.float32) * res_scale, q, bend,
                        out_f32)
    t = y.to(torch.bfloat16).to(torch.float32)
    if residual.dtype == torch.int8:
        r = residual.to(torch.float32) * res_scale
        if round_res:
            r = r.to(torch.bfloat16).to(torch.float32)
    else:
        r = residual.to(torch.float32)
    y = torch.clamp_min(t + r, 0.0)
    return _outputs(y, q, bend, out_f32)


def _outputs(y: torch.Tensor, q: Optional[float], bend: bool,
             out_f32: bool = False):
    if q is not None:
        out = _quant_i8(y, q)
    else:
        out = y if out_f32 else y.to(torch.bfloat16)
    return (out, y.to(torch.bfloat16)) if bend else out


def int8_conv(x: torch.Tensor, w: torch.Tensor, gain_a: torch.Tensor,
              bias_b: torch.Tensor, stride: int = 1,
              act: Optional[str] = "relu", q: Optional[float] = None,
              residual: Optional[torch.Tensor] = None,
              res_scale: Optional[float] = None, round_res: bool = False,
              groups: int = 1, dilation: int = 1, bend: bool = False,
              linear_res: bool = False, out_f32: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K2: ``x`` int8 (B, H, W, Cin) conv ``w`` int8 (Cout, k, k, Cin /
    groups), stride ``stride``, dilation ``dilation``, pad ``dilation * (k
    // 2)``, then the epilogue in the module docstring. ``gain_a``/
    ``bias_b``: f32 (Cout,). ``q``/``res_scale`` are float32 values. With
    ``bend``, returns ``(out, y_bf16)``. CUDA tensors run the kernel (the
    grouped kernel where ``groups > 1``), CPU tensors the plain version."""
    act_code_i8("int8_conv", act)
    if out_f32 and (q is not None or bend):
        raise ValueError("int8_conv: out_f32 takes no q and no bend")
    if act == "relu6" and residual is not None:
        raise ValueError("int8_conv: relu6 applies where there is no "
                         "residual")
    if linear_res and (residual is None or residual.dtype != torch.int8
                       or res_scale is None or round_res):
        raise ValueError("int8_conv: linear_res takes an int8 residual and "
                         "its res_scale, unrounded")
    if dilation < 1:
        raise ValueError(f"int8_conv: dilation {dilation} must be >= 1")
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"int8_conv: x must be int8 NHWC, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[1] != w.shape[2]:
        raise ValueError(f"int8_conv: w must be int8 (Cout,k,k,Cin), got "
                         f"{w.dtype} {tuple(w.shape)}")
    bsz, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    if groups < 1 or w.shape[3] * groups != cin or cout % groups != 0:
        raise ValueError(f"int8_conv: Cin mismatch x {cin} vs w "
                         f"{w.shape[3]} x groups {groups}, or Cout {cout} "
                         f"not a multiple of the groups (grouped convs "
                         f"pass groups=)")
    if groups == 1 and cin % 4 != 0:
        raise ValueError(f"int8_conv: Cin={cin} is not a multiple of 4")
    if groups > 1 and (w.shape[3] not in GROUP_WIDTHS or
                       (cout // groups) % 2 != 0):
        raise ValueError(f"int8_conv: grouped conv of {cin // groups} input "
                         f"and {cout // groups} output channels a group; the "
                         f"kernel takes input widths {GROUP_WIDTHS} and even "
                         f"output widths")
    if k % 2 != 1:
        raise ValueError(f"int8_conv: kernel size {k} must be odd")
    for v in (gain_a, bias_b):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"int8_conv: gain/bias must be f32 ({cout},)")
    pad = dilation * (k // 2)
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (wd + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    tensors = [x, w, gain_a, bias_b]
    res_mode = _RES_NONE
    if residual is not None:
        if tuple(residual.shape) != (bsz, ho, wo, cout):
            raise ValueError(f"int8_conv: residual shape {tuple(residual.shape)}"
                             f" != output {(bsz, ho, wo, cout)}")
        if residual.dtype == torch.int8:
            if res_scale is None:
                raise ValueError("int8_conv: int8 residual needs res_scale")
            res_mode = _RES_F32 if linear_res else (
                _RES_I8_BF16 if round_res else _RES_I8)
        elif residual.dtype == torch.bfloat16:
            res_mode = _RES_BF16
        else:
            raise ValueError(f"int8_conv: residual dtype {residual.dtype}")
        tensors.append(residual)
    if not require_cuda_or_cpu("int8_conv", *tensors):
        return int8_conv_reference(x, w, gain_a, bias_b, stride, act, q,
                                   residual, res_scale, round_res, dilation,
                                   bend, groups, linear_res, out_f32)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_conv: inputs must be contiguous")
    m = bsz * ho * wo
    if m >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"int8_conv: {tuple(x.shape)} -> {m} pixels "
                         "exceeds the kernel's indexing")
    out_mode = _OUT_I8 if q is not None else (_OUT_F32 if out_f32
                                              else _OUT_BF16)
    if groups > 1:
        if any(t is not None and t.data_ptr() % 16
               for t in (x, w, residual)):
            raise ValueError("int8_conv: a grouped conv's x, w and residual "
                             "must be 16-byte aligned")
        return _launch_grouped(x, w, gain_a, bias_b, stride, act, q,
                               residual, res_scale, res_mode, dilation, bend,
                               groups, out_mode)
    return _launch(x, w, gain_a, bias_b, stride, act, q, residual,
                   res_scale, res_mode, dilation, bend, out_mode,
                   plan(m, cout, cin, k))


def _empty_outputs(x, w, stride, pad, dilation, bend, out_mode):
    """A conv's output (int8, bf16 or f32 as ``out_mode`` says) and, with
    ``bend``, its bf16 twin, allocated on x's card."""
    k = w.shape[1]
    ho = (x.shape[1] + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (x.shape[2] + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    shape = (x.shape[0], ho, wo, w.shape[0])
    dtype = {_OUT_I8: torch.int8, _OUT_F32: torch.float32,
             _OUT_BF16: torch.bfloat16}[out_mode]
    out = torch.empty(shape, dtype=dtype, device=x.device)
    out_bf16 = torch.empty(shape, dtype=torch.bfloat16,
                           device=x.device) if bend else None
    return out, out_bf16


def _launch(x, w, gain_a, bias_b, stride, act, q, residual, res_scale,
            res_mode, dilation, bend, out_mode, tile):
    """K2 on the card in blocks of ``tile`` = (BM, BN) (checked operands;
    :func:`plan`'s tile, or another of :data:`TILES` for the card tests
    and the plans tool)."""
    bsz, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    pad = dilation * (k // 2)
    out, out_bf16 = _empty_outputs(x, w, stride, pad, dilation, bend,
                                   out_mode)
    ho, wo = out.shape[1], out.shape[2]
    lib = library()
    with device_of(x):
        check(lib.pcv_int8_conv(
            x.data_ptr(), w.data_ptr(), gain_a.data_ptr(), bias_b.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            float(res_scale or 0.0), res_mode, ACTS_I8[act],
            float(q or 0.0), out_mode, out.data_ptr(), bsz, h, wd, cin, ho,
            wo,
            cout, k, k, stride, pad, dilation,
            out_bf16.data_ptr() if bend else None, tile[0], tile[1],
            stream_of(x)), "int8_conv")
    LAUNCHES["int8_conv"] += 1
    return (out, out_bf16) if bend else out


def _launch_grouped(x, w, gain_a, bias_b, stride, act, q, residual,
                    res_scale, res_mode, dilation, bend, groups, out_mode,
                    tile=None):
    """The grouped kernel on the card (checked operands) under
    :func:`gconv_plan`'s plan, or under block tile ``tile`` = (bm, bn) of
    :data:`GCONV_TILES` (the card tests and the plans tool)."""
    bsz, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    pad = dilation * (k // 2)
    out, out_bf16 = _empty_outputs(x, w, stride, pad, dilation, bend,
                                   out_mode)
    ho, wo = out.shape[1], out.shape[2]
    args = (bsz, h, wd, cin, cout, groups, k, stride, dilation)
    p = gconv_plan(*args) if tile is None else gconv_tile(*args, *tile)
    if p is None:
        raise ValueError(f"int8_conv: grouped tile {tile} exceeds shared "
                         f"memory")
    with device_of(x):
        check(library().pcv_int8_gconv(
            x.data_ptr(), w.data_ptr(), gain_a.data_ptr(), bias_b.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            float(res_scale or 0.0), res_mode, ACTS_I8[act],
            float(q or 0.0), out_mode, out.data_ptr(),
            out_bf16.data_ptr() if bend else None, bsz, h, wd, cin, ho, wo,
            cout, k, stride, pad, dilation, groups, p.bm, p.bn, p.u, p.imgs,
            p.th, p.tw, p.vec, p.wb, stream_of(x)),
            "int8_conv (grouped)")
    LAUNCHES["int8_gconv"] += 1
    return (out, out_bf16) if bend else out


def gconv_info(plan: GPlan) -> dict:
    """Registers a thread, spilled (local) bytes and static shared memory
    of the grouped instance ``plan`` launches, and the blocks an SM holds at
    its dynamic shared memory (needs the card)."""
    out = (ctypes.c_int * 4)()
    check(library().pcv_int8_gconv_info(plan.bm, plan.bn, plan.u,
                                        plan.smem, out),
          "int8_conv (grouped) info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "blocks_per_sm"), out), dynamic_smem=plan.smem)


def instance_info(bm: int, bn: int, vec16: bool) -> dict:
    """Registers a thread, spilled (local) bytes, static and dynamic shared
    memory a block of the K2 instance of tile ``bm`` x ``bn`` with 16-byte
    (``vec16``) or 4-byte copies (needs the card)."""
    out = (ctypes.c_int * 4)()
    check(library().pcv_int8_conv_info(bm, bn, int(vec16), out),
          "int8_conv info")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem"), out))


def kernel_info(m: int, cout: int, cin: int, k: int) -> dict:
    """:func:`instance_info` of the instance that a conv of ``m`` output
    pixels, ``cout`` x ``cin`` channels and a ``k`` x ``k`` kernel
    launches, with its plan's tile ``bm`` x ``bn``."""
    bm, bn = plan(m, cout, cin, k)
    return dict(instance_info(bm, bn, cin % 16 == 0), bm=bm, bn=bn)
