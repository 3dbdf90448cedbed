"""Image-quality metrics and host histogram matching.

MSE/RMSE/MAE as in the reference's scripts/infer.py:148-171; PSNR with the
reference's sentinel of 100 dB when MSE < 1e-10; histogram matching
equivalent to skimage.exposure.match_histograms for one channel.
"""

from __future__ import annotations

import numpy as np
import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.float() - b.float()) ** 2).mean()


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(mse(a, b))


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         sentinel: float = 100.0) -> torch.Tensor:
    """PSNR in dB; ``sentinel`` when MSE < 1e-10."""
    err = mse(a, b)
    value = 10.0 * torch.log10((data_range ** 2) / err.clamp_min(1e-30))
    return torch.where(err < 1e-10, torch.full_like(value, sentinel), value)


def match_histograms_np(image: np.ndarray,
                        reference: np.ndarray) -> np.ndarray:
    """Exact quantile-mapping histogram match (host, unique-value based):
    each source value's empirical quantile maps onto the reference's inverse
    CDF, interpolated linearly between unique reference values."""
    src = np.asarray(image)
    ref = np.asarray(reference)
    _, src_unique_indices, src_counts = np.unique(
        src.ravel(), return_inverse=True, return_counts=True)
    src_quantiles = np.cumsum(src_counts) / src.size
    ref_values, ref_counts = np.unique(ref.ravel(), return_counts=True)
    ref_quantiles = np.cumsum(ref_counts) / ref.size
    interp_values = np.interp(src_quantiles, ref_quantiles, ref_values)
    return interp_values[src_unique_indices].reshape(src.shape).astype(
        src.dtype)
