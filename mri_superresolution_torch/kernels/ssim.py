"""Fused per-image SSIM: kernel B2.

Replaces the TPU kernel ``experiments/ssim_pallas.py``
(``ssim_fused_per_sample``). The CUDA source is ``csrc/ssim_fused.cu``;
its note says what bounds it on the H100 and how the tiles with a halo
replace the TPU kernel's whole image in VMEM. The plain version is
``ops.ssim.ssim(..., size_average=False)``. Forward only: serving needs no
gradient.
"""

from __future__ import annotations

import torch

from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.ops.ssim import _gaussian_window_np, ssim

MAX_WINDOW = 15
_TILE = 32          # the kernel's output tile (csrc/ssim_fused.cu kTile)


def ssim_per_sample_plain(img1: torch.Tensor, img2: torch.Tensor,
                          window_size: int = 11, sigma: float = 1.5,
                          val_range: float = 1.0) -> torch.Tensor:
    return ssim(img1[..., None], img2[..., None], window_size, sigma,
                val_range, size_average=False)


def ssim_per_sample(img1: torch.Tensor, img2: torch.Tensor,
                    window_size: int = 11, sigma: float = 1.5,
                    val_range: float = 1.0) -> torch.Tensor:
    """Per-image SSIM (B,) fp32 of single-channel batches, (B, H, W) or
    (B, H, W, 1). The kernel takes contiguous float32 inputs on the card;
    CPU tensors go to the plain version."""
    if img1.dim() == 4:
        if img1.shape[-1] != 1 or img2.shape[-1] != 1:
            raise ValueError("fused SSIM is single-channel")
        img1, img2 = img1[..., 0], img2[..., 0]
    if img1.dim() != 3 or img1.shape != img2.shape:
        raise ValueError(f"inputs must be matching (B, H, W), got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise TypeError("fused SSIM takes float32 inputs")
    if img1.device != img2.device:
        raise ValueError("inputs must share a device")
    if window_size % 2 == 0 or window_size > MAX_WINDOW:
        raise ValueError(f"window_size must be odd and <= {MAX_WINDOW}")
    if img1.device.type == "cpu":
        return ssim_per_sample_plain(img1, img2, window_size, sigma,
                                     val_range)
    if img1.device.type != "cuda":
        raise ValueError(f"unsupported device {img1.device}")
    if not (img1.is_contiguous() and img2.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    b, h, w = img1.shape
    dev = img1.device
    win = torch.from_numpy(_gaussian_window_np(window_size, sigma)).to(dev)
    tiles = -(-h // _TILE) * -(-w // _TILE)
    partial = torch.empty((b, tiles), dtype=torch.float32, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    code = _build.library().msr_ssim_fwd(
        img1.data_ptr(), img2.data_ptr(), win.data_ptr(), partial.data_ptr(),
        out.data_ptr(), b, h, w, window_size, (0.01 * val_range) ** 2,
        (0.03 * val_range) ** 2, _build.stream_ptr(dev))
    ssim_per_sample.launches += 1
    _build.check(code, "ssim_per_sample")
    return out


ssim_per_sample.launches = 0
