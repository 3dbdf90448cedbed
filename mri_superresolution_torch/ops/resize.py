"""Separable resampling as two matrix products.

The per-axis weight matrices are built on the host in numpy and reproduce
OpenCV's ``cv2.resize`` float path (coordinate convention
``fx = (dst + 0.5) * scale - 0.5``, replicate borders, Catmull-Rom cubic
with A = -0.75, 8-tap normalized Lanczos4, area averaging for downscale and
OpenCV's 2-tap rule for AREA upscale). ``resize`` serves the bicubic target
resize of ``InferenceEngine.calculate_metrics``, the extraction's letterbox
(``letterbox_resize``, with ``center_crop`` and ``pad_to_size`` beside it
for ``ops/pipeline.py``) and the baselines; the model uses
``upsample_bilinear_align_corners``. Matrices are fp32 and the products
run in fp32: nothing here turns on TF32, which would move a LANCZOS
letterbox by several 8-bit codes.
"""

from __future__ import annotations

import enum
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Interp(enum.Enum):
    """Interpolation kernels, mirroring cv2's enum semantics."""

    NEAREST = "nearest"
    LINEAR = "linear"
    CUBIC = "cubic"
    AREA = "area"
    LANCZOS = "lanczos4"


_CUBIC_A = -0.75  # OpenCV's fixed Catmull-Rom-like coefficient


def _cubic_weights(fx: np.ndarray) -> np.ndarray:
    """4 cubic tap weights for fractional offsets fx in [0,1). Shape (n, 4)."""
    A = _CUBIC_A
    w0 = ((A * (fx + 1) - 5 * A) * (fx + 1) + 8 * A) * (fx + 1) - 4 * A
    w1 = ((A + 2) * fx - (A + 3)) * fx * fx + 1
    w2 = ((A + 2) * (1 - fx) - (A + 3)) * (1 - fx) * (1 - fx) + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


def _lanczos4_weights(fx: np.ndarray) -> np.ndarray:
    """8 Lanczos4 tap weights (normalized to sum 1). Shape (n, 8)."""
    d = fx[:, None] + 3.0 - np.arange(8)[None, :]

    def sinc(x):
        x = np.where(x == 0, 1e-30, x)
        return np.sin(np.pi * x) / (np.pi * x)

    w = np.where(np.abs(d) < 1e-7, 1.0, sinc(d) * sinc(d / 4.0))
    return w / w.sum(axis=-1, keepdims=True)


def _linear_weights(fx: np.ndarray) -> np.ndarray:
    return np.stack([1.0 - fx, fx], axis=-1)


def _tap_matrix(in_size: int, taps: np.ndarray,
                weights: np.ndarray) -> np.ndarray:
    """Scatter (out, k) tap weights into a dense (out, in) matrix; taps
    outside [0, in_size) accumulate onto the edge pixel (replicate)."""
    out_size, k = taps.shape
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    clamped = np.clip(taps, 0, in_size - 1)
    for j in range(k):
        np.add.at(mat, (np.arange(out_size), clamped[:, j]), weights[:, j])
    return mat


def _area_down_matrix(in_size: int, out_size: int) -> np.ndarray:
    """True area-average weights for downscale (cv2 INTER_AREA, scale >= 1)."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        lo = o * scale
        hi = (o + 1) * scale
        j0 = int(np.floor(lo))
        j1 = min(int(np.ceil(hi)), in_size)
        for j in range(j0, j1):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                mat[o, j] = overlap / scale
    return mat


@functools.lru_cache(maxsize=512)
def resample_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """The (out_size, in_size) float32 resampling matrix for one axis;
    ``method`` is an ``Interp`` value string."""
    dst = np.arange(out_size, dtype=np.float64)
    scale = in_size / out_size

    if method == Interp.NEAREST.value:
        sx = np.clip(np.floor(dst * scale).astype(np.int64), 0, in_size - 1)
        mat = np.zeros((out_size, in_size), dtype=np.float64)
        mat[np.arange(out_size), sx] = 1.0
        return mat.astype(np.float32)

    if method == Interp.AREA.value:
        if scale >= 1.0:
            return _area_down_matrix(in_size, out_size).astype(np.float32)
        # cv2 AREA upscale: special coordinate rule + 2-tap linear weights
        inv_scale = 1.0 / scale
        sx = np.floor(dst * scale).astype(np.int64)
        fx = (dst + 1) - (sx + 1) * inv_scale
        fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
        taps = np.stack([sx, sx + 1], axis=-1)
        return _tap_matrix(in_size, taps,
                           _linear_weights(fx)).astype(np.float32)

    fx_full = (dst + 0.5) * scale - 0.5
    sx = np.floor(fx_full).astype(np.int64)
    fx = fx_full - sx

    if method == Interp.LINEAR.value:
        taps = np.stack([sx, sx + 1], axis=-1)
        w = _linear_weights(fx)
    elif method == Interp.CUBIC.value:
        taps = sx[:, None] + np.arange(-1, 3)[None, :]
        w = _cubic_weights(fx)
    elif method == Interp.LANCZOS.value:
        taps = sx[:, None] + np.arange(-3, 5)[None, :]
        w = _lanczos4_weights(fx)
    else:
        raise ValueError(f"Unknown interpolation method: {method}")

    return _tap_matrix(in_size, taps, w).astype(np.float32)


def resize(image: torch.Tensor, target_hw: Tuple[int, int],
           method: Interp = Interp.LINEAR) -> torch.Tensor:
    """Resize the trailing two spatial axes of ``image`` (``(H, W)`` or
    ``(..., H, W)``) to ``target_hw`` as two matrix products; matches
    cv2.resize's float32 path."""
    h, w = image.shape[-2], image.shape[-1]
    th, tw = target_hw
    if (h, w) == (th, tw):
        return image
    dt = image.dtype if image.dtype in (torch.float32, torch.float64) \
        else torch.float32
    wr = torch.from_numpy(resample_matrix(h, th, method.value)).to(
        image.device, dt)
    wc = torch.from_numpy(resample_matrix(w, tw, method.value)).to(
        image.device, dt)
    x = image.to(dt)
    # out[..., o, p] = sum_{h,w} Wr[o,h] * x[..., h, w] * Wc[p,w]
    return wr @ x @ wc.T


def upsample_bilinear_align_corners(x: torch.Tensor,
                                    factor: int = 2) -> torch.Tensor:
    """Bilinear upsample with align_corners=True on an NHWC tensor, as two
    matrix products over the spatial axes (torch ``nn.Upsample(
    scale_factor=f, mode='bilinear', align_corners=True)``). The matrices
    are rounded to ``x.dtype`` as in the JAX package. A contiguous NHWC
    input needs no layout copies: both products contract a row-major axis.
    """
    b, h, w, c = x.shape
    th, tw = h * factor, w * factor
    wr = _align_corners_tensor(h, th, x.device, x.dtype)
    wc = _align_corners_tensor(w, tw, x.device, x.dtype)
    y = torch.matmul(wr, x.reshape(b, h, w * c))              # (b, th, w*c)
    y = torch.matmul(wc, y.reshape(b * th, w, c))             # (b*th, tw, c)
    return y.reshape(b, th, tw, c)


@functools.lru_cache(maxsize=64)
def _align_corners_tensor(in_size: int, out_size: int, device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """The matrix on the device, uploaded once per shape instead of once
    per forward. Made outside inference mode even when the first caller
    serves under it, so that a training step may use it later."""
    with torch.inference_mode(False):
        return torch.from_numpy(_align_corners_matrix(in_size, out_size)).to(
            device, dtype)


@functools.lru_cache(maxsize=128)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    if in_size == 1:
        return np.ones((out_size, 1), dtype=np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    f = src - i0
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.arange(out_size), i0), 1.0 - f)
    np.add.at(mat, (np.arange(out_size), i1), f)
    return mat.astype(np.float32)


def letterbox_geometry(in_hw: Tuple[int, int],
                       target_size: Tuple[int, int]
                       ) -> Tuple[int, int, int, int]:
    """(new_h, new_w, y_offset, x_offset) of an aspect-preserving fit of
    ``in_hw`` into ``target_size``, which is (width, height) as in the
    reference (utils/preprocessing.py:23-57)."""
    h, w = in_hw
    target_w, target_h = target_size
    scale = min(target_w / w, target_h / h)
    new_w, new_h = int(w * scale), int(h * scale)
    return new_h, new_w, (target_h - new_h) // 2, (target_w - new_w) // 2


def letterbox_resize(image: torch.Tensor, target_size: Tuple[int, int],
                     method: Interp = Interp.LANCZOS,
                     pad_value: float = 0.0) -> torch.Tensor:
    """Aspect-preserving resize of the trailing (H, W) axes onto a
    ``target_size`` (width, height) canvas filled with ``pad_value``,
    centred (reference ``letterbox_resize``, utils/preprocessing.py:23-57).
    """
    h, w = image.shape[-2], image.shape[-1]
    target_w, target_h = target_size
    new_h, new_w, y_off, x_off = letterbox_geometry((h, w), target_size)
    resized = resize(image, (new_h, new_w), method)
    return F.pad(resized, (x_off, target_w - new_w - x_off,
                           y_off, target_h - new_h - y_off), value=pad_value)


def center_crop(image: torch.Tensor,
                target_size: Tuple[int, int]) -> torch.Tensor:
    """Centre crop of the trailing (H, W) axes to ``target_size`` (width,
    height); an axis smaller than its target is zero-padded, centred
    (reference ``center_crop``, utils/preprocessing.py:59-91)."""
    h, w = image.shape[-2], image.shape[-1]
    target_w, target_h = target_size
    start_x = max(0, (w - target_w) // 2)
    start_y = max(0, (h - target_h) // 2)
    cropped = image[..., start_y:min(h, start_y + target_h),
                    start_x:min(w, start_x + target_w)]
    ch, cw = cropped.shape[-2], cropped.shape[-1]
    if ch < target_h or cw < target_w:
        py, px = (target_h - ch) // 2, (target_w - cw) // 2
        return F.pad(cropped, (px, target_w - cw - px,
                               py, target_h - ch - py), value=0.0)
    return cropped


def pad_to_size(image: torch.Tensor, target_size: Tuple[int, int],
                pad_value: float = 0.0) -> torch.Tensor:
    """Pad the trailing (H, W) axes, centred and without resizing, to
    ``target_size`` (width, height); an axis larger than its target keeps
    its first rows or columns (reference ``pad_to_size``,
    utils/preprocessing.py:93-124)."""
    h, w = image.shape[-2], image.shape[-1]
    target_w, target_h = target_size
    paste_h, paste_w = min(h, target_h), min(w, target_w)
    py, px = max(0, (target_h - h) // 2), max(0, (target_w - w) // 2)
    return F.pad(image[..., :paste_h, :paste_w],
                 (px, target_w - paste_w - px, py, target_h - paste_h - py),
                 value=pad_value)
