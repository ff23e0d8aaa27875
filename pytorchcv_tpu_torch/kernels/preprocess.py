"""Eval preprocessing: uint8 frames -> normalized model input (kernel K1).

The protocol is the TorchVision PIL stack the zoo's accuracy figures assume:
resize the short side to ``round(crop / scale)`` with PIL's antialiased
bilinear filter, centre-crop, normalize. A separable resize with static
shapes is two interpolation matrices, ``R @ X @ Ct``; the crop folds into
their rows and the normalization into the epilogue, so one kernel reads
the uint8 frame once and writes the model input once
(``csrc/preprocess.cu``). Counterpart of ``pytorchcv_tpu.kernels.preprocess``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ._build import (LAUNCHES, check, library, no_tf32, require_cuda_or_cpu,
                     stream_of)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "CIFAR_MEAN", "CIFAR_STD",
           "resize_matrices", "eval_protocol", "preprocess",
           "preprocess_reference", "preprocess_batch",
           "classification_preprocess", "segmentation_preprocess",
           "bf16_ulp_distance", "bf16_ulp_error"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2023, 0.1994, 0.2010)

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _pil_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic PIL-bilinear filter matrix.

    Mirrors Pillow's ``precompute_coeffs`` (triangle filter, support 1.0,
    widened by the scale ratio when downscaling, weights renormalized).
    """
    m = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        js = np.arange(xmin, xmax)
        w = 1.0 - np.abs((js + 0.5 - center) / filterscale)
        w = np.clip(w, 0.0, None)
        s = w.sum()
        if s > 0:
            m[i, xmin:xmax] = w / s
        else:
            m[i, min(int(center), in_size - 1)] = 1.0
    return m.astype(np.float32)


def resize_matrices(in_hw: Tuple[int, int],
                    crop_size: Union[int, Tuple[int, int]],
                    scale: float = 0.875) -> Tuple[np.ndarray, np.ndarray]:
    """``(R (crop_h, in_h), C (crop_w, in_w))`` for resize-short-side to
    ``round(crop_h / scale)`` followed by a centre crop. The long side is
    truncated as torchvision's ``Resize`` does."""
    in_h, in_w = in_hw
    if isinstance(crop_size, int):
        crop_h = crop_w = crop_size
    else:
        crop_h, crop_w = crop_size
    resize_value = int(round(crop_h / scale))
    if in_h <= in_w:
        rh = resize_value
        rw = max(int(in_w * resize_value / in_h), crop_w)
    else:
        rw = resize_value
        rh = max(int(in_h * resize_value / in_w), crop_h)
    full_r = _pil_bilinear_matrix(in_h, rh)
    full_c = _pil_bilinear_matrix(in_w, rw)
    top = (rh - crop_h) // 2
    left = (rw - crop_w) // 2
    return full_r[top:top + crop_h], full_c[left:left + crop_w]


def _affine(mean: Sequence[float], std: Sequence[float]):
    """uint8 pixel -> normalized float: y = v * a + b per channel."""
    a = 1.0 / (255.0 * np.asarray(std, np.float32))
    b = -np.asarray(mean, np.float32) / np.asarray(std, np.float32)
    return a, b


def eval_protocol(model_name: str, model_in_size=None):
    """``(mode, crop_hw, scale, mean, std)`` for a zoo name, from its
    metainfo row: ImageNet/CUB rows resize+crop, CIFAR/SVHN rows
    ('cf') feed the native size directly. A null metainfo ``in_size``
    resolves from ``model_in_size``; it never defaults to 224."""
    from ..zoo.store import get_model_metainfo_dict
    info = get_model_metainfo_dict().get(model_name) or {}
    in_size = info.get("in_size")
    if in_size:
        crop_hw = (int(in_size), int(in_size))
    elif model_in_size is not None:
        if isinstance(model_in_size, int):
            crop_hw = (model_in_size, model_in_size)
        else:
            crop_hw = (int(model_in_size[0]), int(model_in_size[1]))
    else:
        raise ValueError(
            f"{model_name!r}: metainfo in_size is null; pass the model's "
            f"constructor in_size via model_in_size")
    if info.get("dataset") == "cf":
        return ("direct", crop_hw, 1.0, CIFAR_MEAN, CIFAR_STD)
    scale = float(info.get("scale") or 0.875)
    return ("resize_crop", crop_hw, scale, IMAGENET_MEAN, IMAGENET_STD)


def preprocess_reference(images: torch.Tensor, r: torch.Tensor,
                         ct: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         out_dtype=torch.bfloat16,
                         layout: str = "nhwc") -> torch.Tensor:
    """Plain PyTorch version of K1: the two einsums of the JAX path."""
    with no_tf32():
        x = images.to(torch.float32)
        t = torch.einsum("oh,bhwc->bowc", r, x)
        if layout == "nchw":
            y = torch.einsum("bowc,wp->bcop", t, ct)
            return (y * a[:, None, None] + b[:, None, None]).to(out_dtype)
        y = torch.einsum("bowc,wp->bopc", t, ct)
        return (y * a + b).to(out_dtype)


def preprocess(images: torch.Tensor, r: torch.Tensor, ct: torch.Tensor,
               a: torch.Tensor, b: torch.Tensor, out_dtype=torch.bfloat16,
               layout: str = "nhwc") -> torch.Tensor:
    """K1: ``images`` uint8 (B, H, W, C) -> (B, crop_h, crop_w, C), or
    (B, C, crop_h, crop_w) with ``layout="nchw"``, in ``out_dtype``.

    ``r``: f32 (crop_h, H); ``ct``: f32 (W, crop_w); ``a``, ``b``: f32 (C,)
    per-channel affine. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError(f"preprocess: want uint8 (B,H,W,C), got "
                         f"{images.dtype} {tuple(images.shape)}")
    bsz, h, w, c = images.shape
    if r.dtype != torch.float32 or r.dim() != 2 or r.shape[1] != h:
        raise ValueError(f"preprocess: r must be f32 (crop_h, {h})")
    if ct.dtype != torch.float32 or ct.dim() != 2 or ct.shape[0] != w:
        raise ValueError(f"preprocess: ct must be f32 ({w}, crop_w)")
    for v in (a, b):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"preprocess: a, b must be f32 ({c},)")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"preprocess: out_dtype must be one of {_OUT_DTYPES}")
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"preprocess: unknown layout {layout!r}")
    if not require_cuda_or_cpu("preprocess", images, r, ct, a, b):
        return preprocess_reference(images, r, ct, a, b, out_dtype, layout)
    if not all(t.is_contiguous() for t in (images, r, ct, a, b)):
        raise ValueError("preprocess: inputs must be contiguous")
    if bsz * c > 65535:
        raise ValueError("preprocess: batch * channels exceeds 65535")
    oh, ow = r.shape[0], ct.shape[1]
    planar = layout == "nchw"
    shape = (bsz, c, oh, ow) if planar else (bsz, oh, ow, c)
    out = torch.empty(shape, dtype=out_dtype, device=images.device)
    scratch = torch.empty((bsz * c, oh, w), dtype=torch.float32,
                          device=images.device)
    lib = library()
    with torch.cuda.device(images.device):
        check(lib.pcv_preprocess(
            images.data_ptr(), r.data_ptr(), ct.data_ptr(), a.data_ptr(),
            b.data_ptr(), scratch.data_ptr(), out.data_ptr(), bsz, c, h, w,
            oh, ow, int(planar), int(out_dtype == torch.bfloat16),
            stream_of(images)), "preprocess")
    LAUNCHES["preprocess"] += 1
    return out


def preprocess_batch(images: torch.Tensor, r: torch.Tensor, ct: torch.Tensor,
                     mean: Tuple[float, ...] = IMAGENET_MEAN,
                     std: Tuple[float, ...] = IMAGENET_STD,
                     out_dtype=torch.bfloat16,
                     layout: str = "nhwc") -> torch.Tensor:
    """Resize + centre-crop + normalize a uint8 NHWC batch (``r``:
    (crop_h, H), ``ct``: (W, crop_w), both f32 on the batch's device)."""
    a, b = _affine(mean, std)
    dev = images.device
    return preprocess(images, r, ct, torch.from_numpy(a).to(dev),
                      torch.from_numpy(b).to(dev), out_dtype, layout)


def classification_preprocess(model_name_or_size, in_hw: Tuple[int, int],
                              out_dtype=torch.bfloat16, layout: str = "nhwc",
                              model_in_size=None, device=None):
    """``batch_u8 -> model input`` closure for a zoo name (its metainfo eval
    protocol) or a crop size (ImageNet resize+crop). Matrices and affine
    constants are made once, on ``device``."""
    if isinstance(model_name_or_size, str):
        mode, crop_hw, scale, mean, std = eval_protocol(
            model_name_or_size, model_in_size)
    else:
        mode, crop_hw = "resize_crop", (model_name_or_size,) * 2
        scale, mean, std = 0.875, IMAGENET_MEAN, IMAGENET_STD
    if mode == "direct":
        r = _pil_bilinear_matrix(in_hw[0], crop_hw[0])
        c = _pil_bilinear_matrix(in_hw[1], crop_hw[1])
    else:
        r, c = resize_matrices(in_hw, crop_hw, scale)
    a, b = _affine(mean, std)
    r_t = torch.from_numpy(np.ascontiguousarray(r)).to(device)
    ct_t = torch.from_numpy(np.ascontiguousarray(c.T)).to(device)
    a_t, b_t = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)

    def run(images_u8: torch.Tensor) -> torch.Tensor:
        return preprocess(images_u8, r_t, ct_t, a_t, b_t, out_dtype, layout)

    return run


def segmentation_preprocess(out_hw: Tuple[int, int], in_hw: Tuple[int, int],
                            mean=IMAGENET_MEAN, std=IMAGENET_STD,
                            out_dtype=torch.bfloat16, layout: str = "nhwc",
                            device=None):
    """``batch_u8 -> model input`` closure of the dense-prediction protocol:
    PIL-bilinear resize straight to the model's fixed size (no aspect crop)
    and normalize, as K1's two interpolation products (JAX
    ``kernels/preprocess.py:segmentation_preprocess``)."""
    r = _pil_bilinear_matrix(in_hw[0], out_hw[0])
    c = _pil_bilinear_matrix(in_hw[1], out_hw[1])
    a, b = _affine(mean, std)
    r_t = torch.from_numpy(np.ascontiguousarray(r)).to(device)
    ct_t = torch.from_numpy(np.ascontiguousarray(c.T)).to(device)
    a_t, b_t = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)

    def run(images_u8: torch.Tensor) -> torch.Tensor:
        return preprocess(images_u8, r_t, ct_t, a_t, b_t, out_dtype, layout)

    return run


def bf16_ulp_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-element distance in bf16 units in the last place (0 = equal,
    1 = neighbouring representable values; +0 and -0 are equal)."""
    def ordered(t):
        bits = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(x) - ordered(y)).abs()


def bf16_ulp_error(x: torch.Tensor, ref: torch.Tensor,
                   floor: float = 2.0 ** -8) -> torch.Tensor:
    """Per-element ``|x - ref|`` in bf16 units in the last place of ``ref``,
    the unit taken no finer than at ``floor * max|ref|``. Two f32 results
    that differ only in summation order round to the same or neighbouring
    bf16 values (error <= 1), except where a sum cancels to near zero:
    there the f32 rounding of either exceeds a bf16 ulp of the tiny result,
    and ``bf16_ulp_distance`` is unbounded."""
    r = ref.to(torch.float32)
    mag = torch.maximum(r.abs(), floor * r.abs().max()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (x.to(torch.float32) - r).abs() / ulp
