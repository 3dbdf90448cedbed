"""Image-quality metrics and histogram matching.

MSE/RMSE/MAE as in the reference's scripts/infer.py:148-171; PSNR with the
reference's sentinel of 100 dB when MSE < 1e-10; histogram matching
equivalent to skimage.exposure.match_histograms for one channel, exact on
the host (``match_histograms_np``) and sort-based on the device
(``match_histograms``); ``metric_suites``, the eval CLIs' bundle
(``metric_suite``, scripts/test_comparison.py:164-202) of each pair of a
batch or of one pair, with SSIM through the fused kernel B2 on the card.
"""

from __future__ import annotations

from typing import Dict, List

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


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for 1-D fp32 ``xp`` (sorted) and ``fp``:
    linear between neighbours, ``fp[0]`` below ``xp[0]`` and ``fp[-1]``
    above ``xp[-1]``. XLA's CPU code fuses the last product into the sum
    (one rounding); the sum here is taken in float64, where the product is
    exact, and rounded once."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    slope = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = (fp[i - 1].double() + slope.double() * df.double()).float()
    f = torch.where(dx0, fp[i - 1], f)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def match_histograms(image: torch.Tensor,
                     reference: torch.Tensor) -> torch.Tensor:
    """Sort-based histogram match of one 2D image, on its device: the rank
    quantiles of the source pixels (a stable sort) map onto the sorted
    reference by linear interpolation. Agrees with
    :func:`match_histograms_np` up to ties (the same where the source
    values are distinct, as a model's output is)."""
    src = image.float()
    ref = reference.float()
    n, m = src.numel(), ref.numel()
    order = torch.argsort(src.reshape(-1), stable=True)
    ranks = torch.empty(n, dtype=torch.float32, device=src.device)
    ranks[order] = torch.arange(1, n + 1, dtype=torch.float32,
                                device=src.device)
    ref_sorted = torch.sort(ref.reshape(-1)).values
    ref_quantiles = torch.arange(1, m + 1, dtype=torch.float32,
                                 device=ref.device) / m
    return _interp(ranks / n, ref_quantiles, ref_sorted).reshape(src.shape)


def metric_suites(output: torch.Tensor, target: torch.Tensor,
                  data_range: float = 1.0) -> List[Dict[str, float]]:
    """SSIM/PSNR/MSE/RMSE/MAE of each pair of an (N, H, W) batch (or one
    (H, W) pair), one dict a pair: each value is the JAX package's
    ``metric_suite`` of that pair. SSIM takes one launch of B2 for the
    batch on the card, and the values cross to the host in one fetch."""
    from mri_superresolution_torch.kernels.ssim import ssim_per_sample

    o, t = output.float(), target.float()
    if o.dim() == 2:
        o, t = o[None], t[None]
    diff = o - t
    err = (diff * diff).mean(dim=(1, 2))
    value = 10.0 * torch.log10((data_range ** 2) / err.clamp_min(1e-30))
    cols = torch.stack([ssim_per_sample(o, t),
                        torch.where(err < 1e-10, torch.full_like(value, 100.0),
                                    value),
                        err, err.sqrt(), diff.abs().mean(dim=(1, 2))], 1)
    keys = ("ssim", "psnr", "mse", "rmse", "mae")
    return [dict(zip(keys, row)) for row in cols.cpu().tolist()]
