"""What the kernels' timing tools share (``flash_attention_parts``,
``fused_bottleneck_parts``, ``fused_bottleneck_plans``, ``dwconv_plans``,
``dwconv_parts``): the card's name and power limit, its memory rate, an
nvcc build of variants of a kernel's source, a CUDA-event timer and a
device-time reading. Each needs one CUDA card; ``build`` needs nvcc too.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Callable, Dict

import torch

from ._build import _ARCH, _CSRC, _nvcc

HBM_BYTES_S = 3.35e12   # the H100's memory rate (NVIDIA's data sheet)

# Every pcv_* entry point returns a cudaError_t whose message int8_conv.cu
# defines in the full build; a variant's library links on its own with
# this definition.
_ERR = ('\nextern "C" const char* pcv_error_string(int e) '
        '{ return cudaGetErrorString(static_cast<cudaError_t>(e)); }\n')


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build(sources: Dict[str, str], tmp: str) -> Dict[str, ctypes.CDLL]:
    """Name -> loaded library: each source compiled into directory ``tmp``
    by its own nvcc, all started together."""
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
        cu.write_text(text + _ERR)
        jobs[name] = (so, subprocess.Popen(
            [_nvcc(), *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-shared", f"-I{_CSRC}", str(cu), "-o", str(so)]))
    failed = [name for name, (_, proc) in jobs.items() if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on variant(s) {failed}")
    return {name: ctypes.CDLL(str(so)) for name, (so, _) in jobs.items()}


def cuda_ms(fn: Callable[[], None], reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds a call of ``fn``: CUDA events over ``reps`` calls after
    ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn: Callable[[], None], name: str, reps: int = 10) -> float:
    """Device time a call of the kernels whose name holds ``name``
    (``torch.profiler``); CUDA events over back-to-back calls where the
    profiler sees none or loses events (under half the events' time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    t = [e.self_device_time_total for e in prof.key_averages()
         if name in e.key and e.self_device_time_total > 0]
    events = cuda_ms(fn, 2 * reps)
    dev = sum(t) / 1e3 / reps if t else 0.0
    return dev if dev >= 0.5 * events else events
