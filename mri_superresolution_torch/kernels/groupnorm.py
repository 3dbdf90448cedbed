"""Fused GroupNorm + LeakyReLU (+ residual): kernel B1.

Replaces the TPU kernel ``experiments/groupnorm_pallas.py``
(``fused_group_norm_leaky``, forward ``_pallas_forward``). The CUDA source
is ``csrc/groupnorm_leaky.cu``; its note says what bounds it on the H100
(bytes) and how the two-pass design answers the TPU kernel's sequential
grid. The plain version below is the reference formula: fp32 statistics
(mean, then E[x^2] - mean^2), fp32 affine, LeakyReLU and residual in fp32,
one cast back to x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.ops.functional import GN_EPS, group_norm_fp32

# Elements each block of the kernel streams (its pixel chunk): enough work
# per block to hide the block's set-up, and many blocks per image so that
# batch-1 serving still fills the card.
_CHUNK_ELEMS = 16384
_DTYPES = (torch.float32, torch.bfloat16)


def group_norm_leaky_plain(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor,
                           residual: Optional[torch.Tensor] = None,
                           n_groups: int = 8, negative_slope: float = 0.2,
                           eps: float = GN_EPS) -> torch.Tensor:
    y = F.leaky_relu(group_norm_fp32(x, scale, bias, n_groups, eps),
                     negative_slope)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _check(x, scale, bias, residual, n_groups):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[1]
    if c % n_groups:
        raise ValueError(f"{c} channels do not split into {n_groups} groups")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (make the layout "
                         "right at the call site)")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("residual must match x in shape, dtype, device and "
                         "channels_last layout")


def _launch_geometry(hw: int, c: int, itemsize: int, aligned: bool):
    """(vec, rows, chunk_px, nchunks) of a launch: vec elements per load,
    a power-of-two `rows` of pixels walked together by vpp * rows threads."""
    vec = 16 // itemsize
    if c % vec or not aligned:
        vec = 1
    vpp = c // vec
    rows = 1
    while vpp * rows * 2 <= max(vpp, 256):
        rows *= 2
    if vpp * rows > 1024:
        raise ValueError(f"{c} channels exceed the kernel's 1024 threads")
    if 2 * 4 * c * rows > 48 * 1024:
        raise ValueError(f"{c} channels exceed the kernel's shared memory")
    chunk_px = max(1, _CHUNK_ELEMS // c)
    nchunks = -(-hw // chunk_px)
    return vec, rows, chunk_px, nchunks


def group_norm_leaky(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     n_groups: int = 8, negative_slope: float = 0.2,
                     eps: float = GN_EPS) -> torch.Tensor:
    """``leaky_relu(group_norm(x) * scale + bias) [+ residual]``.

    x: (B, C, H, W) float32 or bfloat16 in channels_last memory; scale,
    bias: (C,) float32; residual: like x. Returns x's dtype and layout.
    The kernel on a CUDA tensor, the plain version on a CPU tensor.
    """
    _check(x, scale, bias, residual, n_groups)
    if x.device.type == "cpu":
        return group_norm_leaky_plain(x, scale, bias, residual, n_groups,
                                      negative_slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    ptrs = [x.data_ptr(), y.data_ptr()]
    if residual is not None:
        ptrs.append(residual.data_ptr())
    vec, rows, chunk_px, nchunks = _launch_geometry(
        h * w, c, x.element_size(), all(p % 16 == 0 for p in ptrs))
    ws = torch.empty((b, nchunks, n_groups, 2), dtype=torch.float32,
                     device=x.device)
    code = _build.library().msr_gn_leaky_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(),
        b, h * w, c, n_groups, chunk_px, nchunks, rows, vec,
        int(x.dtype == torch.bfloat16), eps, negative_slope,
        _build.stream_ptr(x.device))
    group_norm_leaky.launches += 1
    _build.check(code, "group_norm_leaky")
    return y


group_norm_leaky.launches = 0
