"""Build, load and launch-count the port's CUDA kernels.

At first use, ``nvcc`` compiles every source under ``csrc/`` (one process per
source, in parallel) and links them into one shared library with a plain C
interface, keyed by a hash of those sources, under
``pytorchcv_tpu_torch/_build/`` (git-ignored). ``ctypes`` loads it: pointers
and the stream go as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
Nothing here imports or builds at module import, so CPU-only hosts import
the package freely.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_LIB_NAME = "libpytorchcv_kernels.so"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

# Kernel launches per kernel; a wrapper adds one where it launches a
# kernel (never on its CPU path): "int8_gconv" counts int8_conv's grouped
# kernel, "patch_window_sum" each of K10's one or two launches a call.
LAUNCHES: Dict[str, int] = {"preprocess": 0, "int8_conv": 0, "stem": 0,
                            "maxpool_i8": 0, "flash_attention": 0,
                            "deform_sample": 0, "dwconv": 0,
                            "window_attention": 0, "fused_bottleneck": 0,
                            "stem_int8": 0, "patch_window_sum": 0,
                            "int8_gconv": 0, "se_tail": 0, "dwconv_i8": 0}

_lib: Optional[ctypes.CDLL] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pcv_preprocess": [_P, _P, _P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "pcv_preprocess_info": [_I, _I, _I, _P],
    "pcv_int8_conv": [_P, _P, _P, _P, _P, _F, _I, _I, _F, _I, _P]
    + [_I] * 12 + [_P, _I, _I, _P],
    "pcv_int8_conv_info": [_I, _I, _I, _P],
    "pcv_int8_gconv": [_P, _P, _P, _P, _P, _F, _I, _I, _F, _I, _P, _P]
    + [_I] * 20 + [_P],
    "pcv_int8_gconv_info": [_I, _I, _I, _I, _P],
    "pcv_stem": [_P, _P, _P, _F, _I, _I, _P] + [_I] * 7 + [_P],
    "pcv_stem_info": [_I] * 4 + [_P],
    "pcv_maxpool_i8": [_P, _P] + [_I] * 8 + [_P],
    "pcv_maxpool_i8_info": [_I, _P],
    "pcv_flash_attention": [_P, _P, _P, _P] + [_I] * 5 + [_F, _I, _P],
    "pcv_flash_attention_info": [_I, _I, _P],
    "pcv_deform_sample": [_P] * 5 + [_I] * 8 + [_P],
    "pcv_deform_sample_info": [_I] * 3 + [_P],
    "pcv_dwconv": [_P] * 5 + [_I] * 19 + [_P],
    "pcv_dwconv_info": [_I] * 13 + [_P],
    "pcv_window_attention": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    "pcv_window_attention_info": [_I, _I, _I, _P],
    "pcv_fused_bottleneck": [_P] * 10 + [_F] * 4 + [_P] + [_I] * 8 + [_P],
    "pcv_fused_bottleneck_info": [_I, _I, _P],
    "pcv_stem_int8": [_P] * 4 + [_F] * 2 + [_P] + [_I] * 7 + [_P],
    "pcv_stem_int8_info": [_I] * 3 + [_P],
    "pcv_patch_window_sum": [_P] * 4 + [_I] * 4 + [_P, _P],
    "pcv_se_tail": [_P, _P, _P, _I, _F, _F, _I, _P, _I, _I, _I, _P],
    "pcv_dwconv_i8": [_P, _P, _P, _P, _F, _I, _P] + [_I] * 9 + [_P],
    "pcv_dwconv_i8_info": [_I] * 2 + [_P],
}


def f32(v: float) -> float:
    """A Python float (float64) rounded to the nearest float32 value, as
    JAX rounds a Python scalar that meets a float32 array."""
    import numpy as np
    return float(np.float32(v))


@functools.lru_cache(maxsize=None)
def _six(device, dtype):
    import torch
    with torch.inference_mode(False):
        return torch.full((), 6.0, dtype=dtype, device=device)


def div6(x):
    """``x / 6``, correctly rounded on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal (a bit may differ), by
    a tensor it divides. The 0-dim divisor of a real CUDA tensor is made
    once per card and dtype (no fill launch a call)."""
    import torch
    if type(x) is torch.Tensor and x.device.type == "cuda":
        return x / _six(x.device, x.dtype)
    return x / torch.full((), 6.0, dtype=x.dtype, device=x.device)


# The int8 epilogues' activations (K2, K3, K12) and their codes
# (``activate_i8`` in ``csrc/common.cuh``).
ACTS_I8 = {None: 0, "relu": 1, "relu6": 2}


def act_code_i8(name: str, act) -> int:
    """``act``'s code in ``ACTS_I8``; raise for another activation."""
    if act not in ACTS_I8:
        raise ValueError(f"{name}: act {act!r} is not one of "
                         f"{tuple(ACTS_I8)}")
    return ACTS_I8[act]


def activate_i8_reference(y, act):
    """``activate_i8`` in torch: none, ``max(y, 0)`` or ``clip(y, 0, 6)``."""
    if act == "relu6":
        return y.clamp(0.0, 6.0)
    return y.clamp_min(0.0) if act == "relu" else y


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD / digest.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}"
        flags = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 f"-I{_CSRC}"]
        # One nvcc per source, all started together, then one link.
        jobs = []
        for src in sorted(_CSRC.glob("*.cu")):
            obj = out_dir / f".{src.stem}.{tag}.o"
            cmd = [_nvcc(), *flags, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out_dir / f".{_LIB_NAME}.{tag}"
        cmd = [_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        for _, obj, _ in jobs:
            obj.unlink()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pcv_error_string.argtypes = [ctypes.c_int]
    lib.pcv_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a ``pcv_*`` entry point reported a CUDA error."""
    if err != 0:
        msg = _lib.pcv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def stream_of(t) -> int:
    """The raw handle of the current stream on ``t``'s card (no Stream
    object is built: a wrapper asks on every call)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def device_of(t):
    """A context that makes ``t``'s card current: nothing to do when it is
    already (the common case; ``torch.cuda.device`` costs host time on
    every call), else ``torch.cuda.device``."""
    import torch
    if t.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


@contextlib.contextmanager
def no_tf32():
    """Full-f32 matmuls and cuDNN convolutions (the plain versions' and the
    reference forward's precision; cuDNN defaults to TF32 for f32 convs)."""
    import torch
    old_mm = torch.backends.cuda.matmul.allow_tf32
    old_cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_mm
        torch.backends.cudnn.allow_tf32 = old_cudnn


def autograd_records(*tensors) -> bool:
    """Whether autograd would record an operation on ``tensors`` (None
    entries are skipped). The kernels have no backward: their wrappers
    refuse such calls, and the models route them to the plain versions."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def require_cuda_or_cpu(name: str, *tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; raise otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")
