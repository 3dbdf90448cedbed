"""SSIM with exact reference parity (window 11, sigma 1.5, val_range 1.0),
plain PyTorch.

A Gaussian window applied as a zero-padded depthwise convolution to img1,
img2, img1², img2², img1·img2; then the standard SSIM map with
C1=(0.01·L)², C2=(0.03·L)². Everything is fp32. Images are NHWC, as in the
JAX package. The fused CUDA kernel of ``ssim_per_sample`` on the card lives
in ``kernels/ssim.py``; these functions are its plain version.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _gaussian_window_np(window_size: int, sigma: float) -> np.ndarray:
    """1D Gaussian window, normalized to sum 1 (utils/losses.py:10-18)."""
    coords = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _separable_blur(x: torch.Tensor, window_size: int,
                    sigma: float) -> torch.Tensor:
    """Zero-padded depthwise Gaussian blur of an NCHW fp32 tensor: rows,
    then columns (outer(g, g) separates exactly)."""
    c = x.shape[1]
    g = torch.from_numpy(_gaussian_window_np(window_size, sigma)).to(x.device)
    pad = window_size // 2
    x = F.conv2d(x, g.view(1, 1, window_size, 1).expand(c, 1, window_size, 1),
                 padding=(pad, 0), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, window_size).expand(c, 1, 1,
                                                           window_size),
                    padding=(0, pad), groups=c)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5, val_range: float = 1.0) -> torch.Tensor:
    """Per-pixel SSIM map for NHWC images (fp32)."""
    x1 = img1.float().permute(0, 3, 1, 2)
    x2 = img2.float().permute(0, 3, 1, 2)
    c = x1.shape[1]
    blurred = _separable_blur(
        torch.cat([x1, x2, x1 * x1, x2 * x2, x1 * x2], dim=1),
        window_size, sigma)
    mu1, mu2, e11, e22, e12 = blurred.split(c, dim=1)

    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2

    c1 = (0.01 * val_range) ** 2
    c2 = (0.03 * val_range) ** 2
    smap = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return smap.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, val_range: float = 1.0,
         size_average: bool = True,
         sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SSIM index between NHWC image batches (parity: utils/losses.py:27-81).

    size_average: True -> scalar mean over everything; False -> per-sample
    mean over (H, W, C). sample_weights: optional (B,) weights, the weighted
    mean over samples.
    """
    per_sample = ssim_map(img1, img2, window_size, sigma,
                          val_range).mean(dim=(1, 2, 3))
    if not size_average:
        return per_sample
    if sample_weights is not None:
        w = sample_weights.float()
        return (per_sample * w).sum() / w.sum().clamp_min(1e-12)
    return per_sample.mean()
