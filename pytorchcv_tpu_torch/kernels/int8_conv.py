"""int8 NHWC convolution with the serving pipeline's fused epilogue (K2).

One call is one int8 conv of the int8 ResNet pipeline, with its epilogue:

* ``q`` given, no residual: ``clip(rint(max?(acc*A + B) * q), +-127)`` int8
  (``_cell`` with ``s_out``; the max only with ``relu``);
* no ``q``, no residual: ``acc*A + B`` (max with ``relu``) as bf16
  (``_cell`` without ``s_out``);
* residual given (the unit tail): ``t = bf16(acc*A + B)``, ``r`` the
  residual term, ``y = max(t + r, 0)``, int8 via ``q`` or bf16 without it.
  An int8 residual enters as ``f32(res) * res_scale``, rounded to bf16 when
  ``round_res``; a bf16 residual enters as it is.

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
ResNeXt's and SENet's grouped 3x3) runs the grouped kernel of the same
source, ``__dp4a`` products on the CUDA cores with the same epilogue: a
block takes 128 pixels x :func:`gconv_plan`'s channels (whole groups), a
thread ``opt`` outputs of one group at one pixel, reading only that
group's input channels (:func:`gconv_items` lists the (pixel, channel)
each thread takes, :func:`gconv_words` the weight words a block stages).
Per-group input widths :data:`GROUP_WIDTHS`; the output width per group a
multiple of 2. The plain version is ``F.conv2d(..., groups=)`` in float64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ._build import (LAUNCHES, check, device_of, library,
                     require_cuda_or_cpu, stream_of)

__all__ = ["int8_conv", "int8_conv_reference", "plan", "plan_cost",
           "block_tile", "blocks", "smem_bytes", "kernel_info",
           "instance_info", "TILES", "GROUP_WIDTHS", "gconv_plan",
           "gconv_items", "gconv_words", "gconv_info"]

_RES_NONE, _RES_I8, _RES_I8_BF16, _RES_BF16 = 0, 1, 2, 3

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
# ResNeXt, SE-ResNeXt and SENet of the zoo), and its pixels a block.
GROUP_WIDTHS = (2, 4, 8, 16, 32)
GCONV_PIXELS = 128


@functools.lru_cache(maxsize=256)
def gconv_plan(cout: int, groups: int) -> Tuple[int, int]:
    """(bc, opt) of a grouped conv: the block's channels (whole groups, 64
    or one group if wider, at most ``cout``) and the outputs a thread
    (8, 4 or 2 consecutive channels of one group)."""
    og = cout // groups
    opt = next(o for o in (8, 4, 2) if og % o == 0)
    return min(og * max(1, 64 // og), cout), opt


def gconv_items(m: int, cout: int, groups: int) -> torch.Tensor:
    """(pixel, first channel) of every thread item of a grouped conv of
    ``m`` output pixels, in the kernel's order: block ``b`` takes pixels
    ``b // n_tiles * 128`` on and channels ``b % n_tiles * bc`` on, item
    ``i`` of a block the chunk ``i // 128`` (``opt`` channels) at pixel
    ``i % 128``; items past ``m`` or ``cout`` do nothing and are left
    out."""
    bc, opt = gconv_plan(cout, groups)
    n_tiles = -(-cout // bc)
    n_blocks = -(-m // GCONV_PIXELS) * n_tiles
    block = torch.arange(n_blocks)[:, None]
    item = torch.arange(GCONV_PIXELS * (bc // opt))[None, :]
    pixel = block // n_tiles * GCONV_PIXELS + item % GCONV_PIXELS
    chan = block % n_tiles * bc + item // GCONV_PIXELS * opt
    keep = (pixel < m) & (chan < cout)
    return torch.stack([pixel[keep], chan[keep]], 1)


def gconv_words(w: torch.Tensor) -> torch.Tensor:
    """The int32 words a block stages for each output channel of ``w``
    (Cout, k, k, cg): its k*k*cg bytes in (tap, channel) order, zero-padded
    to a multiple of 4, little-endian (at cg = 2 a word holds two taps)."""
    cout = w.shape[0]
    flat = w.reshape(cout, -1)
    pad = -flat.shape[1] % 4
    b = torch.cat([flat, flat.new_zeros(cout, pad)], 1).to(torch.int64) & 255
    b = b.reshape(cout, -1, 4)
    word = b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _quant_i8(y: torch.Tensor, q: float) -> torch.Tensor:
    return torch.clamp(torch.round(y * q), -127.0, 127.0).to(torch.int8)


def int8_conv_reference(x: torch.Tensor, w: torch.Tensor, gain_a: torch.Tensor,
                        bias_b: torch.Tensor, stride: int = 1,
                        relu: bool = True, q: Optional[float] = None,
                        residual: Optional[torch.Tensor] = None,
                        res_scale: Optional[float] = None,
                        round_res: bool = False, dilation: int = 1,
                        bend: bool = False, groups: int = 1
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
        if relu:
            y = torch.clamp_min(y, 0.0)
        return _outputs(y, q, bend)
    t = y.to(torch.bfloat16).to(torch.float32)
    if residual.dtype == torch.int8:
        r = residual.to(torch.float32) * res_scale
        if round_res:
            r = r.to(torch.bfloat16).to(torch.float32)
    else:
        r = residual.to(torch.float32)
    y = torch.clamp_min(t + r, 0.0)
    return _outputs(y, q, bend)


def _outputs(y: torch.Tensor, q: Optional[float], bend: bool):
    out = y.to(torch.bfloat16) if q is None else _quant_i8(y, q)
    return (out, y.to(torch.bfloat16)) if bend else out


def int8_conv(x: torch.Tensor, w: torch.Tensor, gain_a: torch.Tensor,
              bias_b: torch.Tensor, stride: int = 1, relu: bool = True,
              q: Optional[float] = None,
              residual: Optional[torch.Tensor] = None,
              res_scale: Optional[float] = None, round_res: bool = False,
              groups: int = 1, dilation: int = 1, bend: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K2: ``x`` int8 (B, H, W, Cin) conv ``w`` int8 (Cout, k, k, Cin /
    groups), stride ``stride``, dilation ``dilation``, pad ``dilation * (k
    // 2)``, then the epilogue in the module docstring. ``gain_a``/
    ``bias_b``: f32 (Cout,). ``q``/``res_scale`` are float32 values. With
    ``bend``, returns ``(out, y_bf16)``. CUDA tensors run the kernel (the
    grouped kernel where ``groups > 1``), CPU tensors the plain version."""
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
            res_mode = _RES_I8_BF16 if round_res else _RES_I8
        elif residual.dtype == torch.bfloat16:
            res_mode = _RES_BF16
        else:
            raise ValueError(f"int8_conv: residual dtype {residual.dtype}")
        tensors.append(residual)
    if not require_cuda_or_cpu("int8_conv", *tensors):
        return int8_conv_reference(x, w, gain_a, bias_b, stride, relu, q,
                                   residual, res_scale, round_res, dilation,
                                   bend, groups)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_conv: inputs must be contiguous")
    m = bsz * ho * wo
    if m >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"int8_conv: {tuple(x.shape)} -> {m} pixels "
                         "exceeds the kernel's indexing")
    if groups > 1:
        if any(t is not None and t.data_ptr() % 16
               for t in (x, w, residual)):
            raise ValueError("int8_conv: a grouped conv's x, w and residual "
                             "must be 16-byte aligned")
        return _launch_grouped(x, w, gain_a, bias_b, stride, relu, q,
                               residual, res_scale, res_mode, dilation, bend,
                               groups)
    return _launch(x, w, gain_a, bias_b, stride, relu, q, residual,
                   res_scale, res_mode, dilation, bend,
                   plan(m, cout, cin, k))


def _empty_outputs(x, w, stride, pad, dilation, q, bend):
    """A conv's output (int8 with ``q``, else bf16) and, with ``bend``, its
    bf16 twin, allocated on x's card."""
    k = w.shape[1]
    ho = (x.shape[1] + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (x.shape[2] + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    shape = (x.shape[0], ho, wo, w.shape[0])
    out = torch.empty(shape, dtype=torch.int8 if q is not None
                      else torch.bfloat16, device=x.device)
    out_bf16 = torch.empty(shape, dtype=torch.bfloat16,
                           device=x.device) if bend else None
    return out, out_bf16


def _launch(x, w, gain_a, bias_b, stride, relu, q, residual, res_scale,
            res_mode, dilation, bend, tile):
    """K2 on the card in blocks of ``tile`` = (BM, BN) (checked operands;
    :func:`plan`'s tile, or another of :data:`TILES` for the card tests
    and the plans tool)."""
    bsz, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    pad = dilation * (k // 2)
    out, out_bf16 = _empty_outputs(x, w, stride, pad, dilation, q, bend)
    ho, wo = out.shape[1], out.shape[2]
    lib = library()
    with device_of(x):
        check(lib.pcv_int8_conv(
            x.data_ptr(), w.data_ptr(), gain_a.data_ptr(), bias_b.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            float(res_scale or 0.0), res_mode, int(relu), float(q or 0.0),
            int(q is not None), out.data_ptr(), bsz, h, wd, cin, ho, wo,
            cout, k, k, stride, pad, dilation,
            out_bf16.data_ptr() if bend else None, tile[0], tile[1],
            stream_of(x)), "int8_conv")
    LAUNCHES["int8_conv"] += 1
    return (out, out_bf16) if bend else out


def _launch_grouped(x, w, gain_a, bias_b, stride, relu, q, residual,
                    res_scale, res_mode, dilation, bend, groups):
    """The grouped kernel on the card (checked operands)."""
    bsz, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    pad = dilation * (k // 2)
    out, out_bf16 = _empty_outputs(x, w, stride, pad, dilation, q, bend)
    ho, wo = out.shape[1], out.shape[2]
    bc, opt = gconv_plan(cout, groups)
    with device_of(x):
        check(library().pcv_int8_gconv(
            x.data_ptr(), w.data_ptr(), gain_a.data_ptr(), bias_b.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            float(res_scale or 0.0), res_mode, int(relu), float(q or 0.0),
            int(q is not None), out.data_ptr(),
            out_bf16.data_ptr() if bend else None, bsz, h, wd, cin, ho, wo,
            cout, k, stride, pad, dilation, groups, bc, opt, stream_of(x)),
            "int8_conv (grouped)")
    LAUNCHES["int8_gconv"] += 1
    return (out, out_bf16) if bend else out


def gconv_info(cout: int, cin: int, groups: int) -> dict:
    """Registers a thread, spilled (local) bytes and static shared memory of
    the grouped instance a conv of ``cout`` x ``cin`` channels in
    ``groups`` groups launches, with its plan's ``bc`` and ``opt`` (needs
    the card)."""
    bc, opt = gconv_plan(cout, groups)
    out = (ctypes.c_int * 3)()
    check(library().pcv_int8_gconv_info(cin // groups, opt, out),
          "int8_conv (grouped) info")
    return dict(zip(("registers", "spill_bytes", "static_smem"), out),
                bc=bc, opt=opt)


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
