"""Intensity normalization of a batch of slices, on any device.

The port's own copy of the JAX package's ``ops/normalize.py`` serving half
(``robust_normalize``, ``percentile_window``, ``minmax_normalize``), which
reproduces the reference's NumPy intensity pipeline
(utils/preprocessing.py:126-163, 335-343). JAX vmaps the per-slice
functions over a batch; here each function takes a batch of slices, one
slice a row: (N, h, w) -> (N, h, w) fp32, on the tensor's device.
``apply_windowing``, ``clahe`` and ``histogram_equalization`` wait for the
data pipeline (ROADMAP A13).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _percentile_weights(q: float, n: int) -> Tuple[int, int, float, float]:
    """Indices and weights of ``jnp.percentile``'s ``linear`` method for one
    percentile ``q`` (0-100) of ``n`` sorted values, in fp32 as XLA
    compiles it: the division by 100 becomes a product with fp32(0.01),
    folded with n - 1 into one constant, pos = q * f32(0.01 * (n - 1));
    then low = floor(pos), high = ceil(pos), w_high = pos - low,
    w_low = 1 - w_high."""
    f32 = np.float32
    pos = f32(f32(q) * f32(f32(0.01) * f32(n - 1)))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = f32(pos - low)
    w_low = f32(1) - w_high
    low = int(min(max(low, 0), n - 1))
    high = int(min(max(high, 0), n - 1))
    return low, high, float(w_low), float(w_high)


def _percentiles(x: torch.Tensor, lower: float, upper: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slice percentiles of a (N, h, w) batch as (N, 1, 1) fp32 tensors.

    The formula is ``jnp.percentile``'s (method ``linear``, which NumPy's
    default shares): sort each flattened slice, take the values at
    floor and ceil of pos (``_percentile_weights``), and interpolate as
    v_low * w_low + v_high * w_high — not ``torch.quantile``'s ``lerp``,
    which rounds differently and limits its input size. Over a batch,
    XLA's CPU code fuses the first product into the sum (one rounding):
    here that sum is taken in float64, where the product is exact, and
    rounded once to fp32. A single slice's ``jnp.percentile`` fuses the
    other product instead, one fp32 ulp away at most."""
    flat = x.reshape(x.shape[0], -1).float()
    s = torch.sort(flat, dim=1).values
    out = []
    for q in (lower, upper):
        low, high, w_low, w_high = _percentile_weights(q, s.shape[1])
        v = (s[:, low].double() * w_low
             + (s[:, high] * w_high).double()).float()
        out.append(v[:, None, None])
    return out[0], out[1]


def robust_normalize(x: torch.Tensor, lower_percentile: float = 0.5,
                     upper_percentile: float = 99.5,
                     target_range: Tuple[float, float] = (0.0, 1.0)
                     ) -> torch.Tensor:
    """Percentile-clip each slice, then rescale it to ``target_range``; a
    constant slice becomes zeros (reference
    utils/preprocessing.py:126-163)."""
    x = x.float()
    lo, hi = _percentiles(x, lower_percentile, upper_percentile)
    clipped = torch.minimum(torch.maximum(x, lo), hi)
    denom = hi - lo
    normalized = torch.where(
        denom > 0, (clipped - lo) / torch.where(denom == 0, 1.0, denom), 0.0)
    mn, mx = target_range
    return normalized * (mx - mn) + mn


def percentile_window(x: torch.Tensor, min_percentile: float = 0.5,
                      max_percentile: float = 99.5) -> torch.Tensor:
    """Clip each slice to its [p_min, p_max] percentiles without rescaling
    (the auto branch of the reference's ``preprocess_slice``,
    utils/preprocessing.py:335-338)."""
    x = x.float()
    lo, hi = _percentiles(x, min_percentile, max_percentile)
    return torch.minimum(torch.maximum(x, lo), hi)


def minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """Scale each slice to [0, 1] by its min and max; a constant slice
    passes through unchanged (utils/preprocessing.py:341-343)."""
    x = x.float()
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    denom = mx - mn
    return torch.where(denom > 0,
                       (x - mn) / torch.where(denom == 0, 1.0, denom), x)


def normalize_slices(x: torch.Tensor) -> torch.Tensor:
    """The serving normalize: ``minmax_normalize(percentile_window(x))``
    per slice, as the reference's inference does (scripts/infer.py:97-130)."""
    return minmax_normalize(percentile_window(x))
