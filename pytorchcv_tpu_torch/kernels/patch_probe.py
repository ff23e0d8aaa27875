"""The window-sum probe (K10), the port of ``tools/exp_pallas_patch_probe.py``
(``run_pallas`` and its ``oracle``), the access probe of the deformable
sampler: per start (sy, sx), the f32 sum over a (10, 24, C) window of an
(H, W, C) bf16 map, sx aligned down to a multiple of 8.

Both versions clamp the starts as the oracle's gather in mode "clip" does
(sy into [0, H - 10], the aligned sx into [0, W - 24]), so both define one
function for every input. The tool's ``n % 80 == 0`` was its TPU tile;
``patch_window_sum`` takes any n. The kernel is ``csrc/patch_probe.cu``,
which adds in a fixed order (rows outer, columns inner); the plain version
leaves the order to ``torch.sum``.

The starts fall on few distinct windows (:func:`distinct_windows`: (H - 9)
rows x ``ceil((W - 24) / 8) + 1`` aligned columns, :func:`window_index`
maps a start to its window), so where ``n`` is at least their number the
kernel sums each distinct window once into a scratch table and gathers
the starts' rows from it: two launches, each counted. Where ``n`` is
smaller it sums each start's window directly: one launch.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import (LAUNCHES, autograd_records, check, device_of, library,
                     require_cuda_or_cpu, stream_of)

__all__ = ["patch_window_sum", "patch_window_sum_reference", "PATCH_ROWS",
           "PATCH_COLS", "distinct_windows", "window_index",
           "clamped_starts"]

PATCH_ROWS = 10        # the tool's P
PATCH_COLS = 24        # the tool's QW: 10 columns at any 8-alignment


def _check(x: torch.Tensor, starts: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 3 or \
            x.shape[0] < PATCH_ROWS or x.shape[1] < PATCH_COLS or \
            not 1 <= x.shape[2] <= 1024:
        raise ValueError(f"patch_window_sum: x must be bf16 (H, W, C) with H "
                         f">= {PATCH_ROWS}, W >= {PATCH_COLS}, C <= 1024, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if starts.dtype != torch.int32 or starts.dim() != 2 or \
            starts.shape[1] != 2:
        raise ValueError(f"patch_window_sum: starts must be int32 (n, 2), got "
                         f"{starts.dtype} {tuple(starts.shape)}")


def distinct_windows(h: int, w: int) -> int:
    """The distinct (clamped, aligned) windows of an (h, w) map."""
    return (h - PATCH_ROWS + 1) * (-(-(w - PATCH_COLS) // 8) + 1)


def clamped_starts(starts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(sy, sx) of each window as both versions clamp them: sy into [0, h -
    10], sx aligned down to 8, then into [0, w - 24]; int64 (n, 2)."""
    sy = starts[:, 0].long().clamp(0, h - PATCH_ROWS)
    sx = (torch.div(starts[:, 1].long(), 8, rounding_mode="floor") * 8
          ).clamp(0, w - PATCH_COLS)
    return torch.stack([sy, sx], 1)


def window_index(starts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The kernel's table row of each start: ``sy * nx + ceil(sx / 8)`` (the
    clamped ``w - 24`` is the last column slot, aligned or not)."""
    nx = -(-(w - PATCH_COLS) // 8) + 1
    c = clamped_starts(starts, h, w)
    return c[:, 0] * nx + torch.div(c[:, 1] + 7, 8, rounding_mode="floor")


def patch_window_sum_reference(x: torch.Tensor,
                               starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the tool's ``oracle``): clamp the starts,
    gather the windows, sum them in f32 -> (n, C)."""
    h, w, _ = x.shape
    sy, sx = clamped_starts(starts, h, w).unbind(1)
    rows = sy[:, None] + torch.arange(PATCH_ROWS, device=x.device)
    cols = sx[:, None] + torch.arange(PATCH_COLS, device=x.device)
    patches = x[rows[:, :, None], cols[:, None, :]]        # (n, P, QW, C)
    return patches.to(torch.float32).sum(dim=(1, 2))


def patch_window_sum(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """K10: ``x`` bf16 (H, W, C), ``starts`` int32 (n, 2) of (sy, sx) ->
    f32 (n, C). CUDA tensors run the kernel (two launches where ``n >=
    distinct_windows(H, W)``, else one), CPU tensors the plain version;
    anything else raises, a call that autograd would record included."""
    _check(x, starts)
    if autograd_records(x):
        raise ValueError("patch_window_sum: K10 has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    if not require_cuda_or_cpu("patch_window_sum", x, starts):
        return patch_window_sum_reference(x, starts)
    if not x.is_contiguous() or not starts.is_contiguous():
        raise ValueError("patch_window_sum: inputs must be contiguous")
    h, w, c = x.shape
    n = starts.shape[0]
    if n >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"patch_window_sum: {n} starts or x "
                         f"{tuple(x.shape)} exceed the kernel's range")
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    windows = distinct_windows(h, w)
    table = torch.empty((windows, c), dtype=torch.float32,
                        device=x.device) if n >= windows else None
    launches = ctypes.c_int(0)
    with device_of(x):
        check(library().pcv_patch_window_sum(
            x.data_ptr(), starts.data_ptr(), out.data_ptr(),
            None if table is None else table.data_ptr(), n, h, w, c,
            ctypes.byref(launches), stream_of(x)), "patch_window_sum")
    LAUNCHES["patch_window_sum"] += launches.value
    return out
