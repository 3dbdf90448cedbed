"""Functional building blocks of the unet forward, on NCHW-indexed tensors.

The model keeps its activations NCHW-indexed in ``torch.channels_last``
memory, so these take and return that indexing; the bytes underneath are
NHWC, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

GN_EPS = 1e-5


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Pixel shuffle with torch ``nn.PixelShuffle`` channel ordering (input
    channel ``c*r*r + i*r + j`` -> output channel ``c`` at offset ``(i, j)``),
    which is the JAX package's order too."""
    return F.pixel_shuffle(x, r)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool (floor on odd sizes, like VALID windows)."""
    return F.max_pool2d(x, 2)


def group_norm_fp32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    n_groups: int = 8, eps: float = GN_EPS) -> torch.Tensor:
    """GroupNorm of ``x`` with fp32 statistics (mean, then E[x^2]-mean^2)
    and the fp32 affine, returned in fp32 (no cast back)."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, n_groups, c // n_groups, h, w)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3, 4), keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return y * scale.float().view(1, c, 1, 1) + bias.float().view(1, c, 1, 1)


def group_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   n_groups: int = 8) -> torch.Tensor:
    """``flax.linen.GroupNorm`` numerics (fp32 statistics, E[x^2]-E[x]^2
    variance, fp32 affine, cast back to x.dtype) as a plain function."""
    return group_norm_fp32(x, scale, bias, n_groups).to(x.dtype)


# ---------------------------------------------------------- output packing

# [0,1] output -> integer-coded packing, and the NIfTI scl_slope that
# decodes it back.
PACK_SCALES = {"uint8": 255.0, "int16": 32767.0}
_TORCH_DTYPES = {"uint8": torch.uint8, "int16": torch.int16}


def pack_scale(dtype) -> float:
    """Packing scale for a [0,1]-coded output dtype (1.0 = no packing)."""
    return PACK_SCALES.get(np.dtype(dtype).name, 1.0)


def unit_slope(dtype) -> float:
    """The scl_slope that decodes a packed volume back to [0,1]."""
    return 1.0 / pack_scale(dtype)


def pack_unit(y: torch.Tensor, dtype) -> torch.Tensor:
    """Device-side packing: round(clip(y, 0, 1) * scale) as ``dtype``;
    identity for float32. Rounds half to even, as numpy does."""
    name = np.dtype(dtype).name
    if name not in PACK_SCALES:
        return y
    return torch.round(y.clamp(0.0, 1.0) * PACK_SCALES[name]).to(
        _TORCH_DTYPES[name])


def pack_unit_np(y, dtype):
    """Host twin of :func:`pack_unit` (numpy)."""
    dt = np.dtype(dtype)
    if dt.name not in PACK_SCALES:
        return y
    return np.round(np.clip(y, 0.0, 1.0) * PACK_SCALES[dt.name]).astype(dt)
