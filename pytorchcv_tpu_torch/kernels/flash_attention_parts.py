"""Where K4's bf16 time goes: the kernel timed with parts of its work taken
out of copies of ``csrc/flash_attention.cu``.

    python -m pytorchcv_tpu_torch.kernels.flash_attention_parts

Needs one CUDA card and nvcc. Builds each variant into a temporary
directory (one nvcc per variant, in parallel) and times it on DANet's
batch-8 position attention (q, k (8, 3600, 64), v (8, 3600, 512), bf16,
numpy seed 0) with CUDA events over 20 launches after 3. The variants
compute wrong outputs on purpose; only their times mean anything. The
differences between them say what each part costs: the lo half of the
p = hi + lo split, the p v products, the v tile loads, the q k^T products,
and exp2f. The last line is one JSON object with the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import re
import tempfile

import numpy as np
import torch

from ._build import _CSRC
from ._parts import build, card, cuda_ms

_PV = r".*mma_bf16\(o\[[^\n]*b\[h\][^\n]*\n"
_S = r".*mma_bf16\(s\[[^\n]*\n"
_V_LOADS = r"\n *load_tile<kTcCols>\([^;]*;"


def variants(src: str) -> dict:
    """Name -> source: the kernel and copies with parts removed."""
    no_pv = re.sub(_PV, "", src)
    no_pv_v = re.sub(_V_LOADS, "", no_pv)
    out = {
        "kernel": src,
        "no lo products": re.sub(
            r".*mma_bf16\(o\[[^\n]*lo, b\[h\][^\n]*\n", "", src),
        "no exp2f": src.replace("sv = exp2f(sv - m_new);", "sv = sv - m_new;"),
        "no p v products": no_pv,
        "no p v products, no v loads": no_pv_v,
        "no products": re.sub(_S, "", no_pv),
        "no products, no v loads": re.sub(_S, "", no_pv_v),
    }
    for name, text in out.items():
        if name != "kernel" and text == src:
            raise RuntimeError(f"variant {name!r} removed nothing: the "
                               f"kernel source no longer matches")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("flash_attention_parts needs a CUDA card")
    src = (_CSRC / "flash_attention.cu").read_text()
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((8, 3600, 64)).astype(
        np.float32) * 0.3).to("cuda", torch.bfloat16) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((8, 3600, 512)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    out = torch.empty_like(v)
    name_card = card()
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, lib in build(variants(src), tmp).items():
            fn = lib.pcv_flash_attention
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), 8, 3600, 3600, 64, 512, 1.0, 1,
                         stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            times[name] = cuda_ms(call, 20, 3)
            print(f"[{name_card}] K4 bf16 (8, 3600, 64) x (8, 3600, 512), "
                  f"{name}: {times[name]:.4f} ms")
    print(json.dumps({"card": name_card, "ms": times}))


if __name__ == "__main__":
    main()
