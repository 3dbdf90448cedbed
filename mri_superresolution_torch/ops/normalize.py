"""Intensity normalization of a batch of slices, on any device.

The port's own copy of the JAX package's ``ops/normalize.py``, which
reproduces the reference's NumPy/cv2 intensity pipeline
(utils/preprocessing.py:126-223, 335-343): ``robust_normalize``,
``percentile_window`` and ``minmax_normalize`` for serving and extraction,
``apply_windowing``, ``clahe`` and ``histogram_equalization`` for
``ops/pipeline.preprocess_slice``. JAX vmaps the per-slice functions over
a batch; here each function takes a batch of slices, one slice a row:
(N, h, w) -> (N, h, w) fp32, on the tensor's device (``clahe`` and
``histogram_equalization`` also take one (h, w) slice).
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


def apply_windowing(x: torch.Tensor, window_center: float,
                    window_width: float,
                    output_range: Tuple[float, float] = (0.0, 1.0)
                    ) -> torch.Tensor:
    """Manual intensity windowing: clip to the window, then rescale it to
    ``output_range`` unless it is empty (reference
    utils/preprocessing.py:193-223)."""
    mn, mx = output_range
    w_min = window_center - window_width / 2.0
    w_max = window_center + window_width / 2.0
    windowed = x.float().clamp(w_min, w_max)
    if w_max > w_min:
        windowed = (windowed - w_min) / (w_max - w_min)
        windowed = windowed * (mx - mn) + mn
    return windowed


def _codes(image: torch.Tensor) -> torch.Tensor:
    """The reference's uint8 quantization before cv2, truncating
    (utils/preprocessing.py:182-183 ``astype(np.uint8)``), as int64."""
    return (image.float() * 255.0).clamp(0, 255).to(torch.int64)


def _reflect101(n: int, size: int, device) -> torch.Tensor:
    """Indices of ``n`` positions of an axis of ``size`` extended past its
    end by reflection without repeating the edge (cv2's BORDER_REFLECT_101,
    ``jnp.pad(mode="reflect")``)."""
    i = torch.arange(n, device=device)
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    i = i % period
    return torch.where(i < size, i, period - i)


def _batched(fn):
    """Run a per-batch function on one (h, w) slice too."""
    def wrapper(image: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        if image.dim() == 2:
            return fn(image[None], *args, **kwargs)[0]
        return fn(image, *args, **kwargs)
    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


@_batched
def clahe(image: torch.Tensor, clip_limit: float = 2.0,
          tile_grid_size: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of [0, 1] slices,
    cv2.createCLAHE(...).apply's semantics (the reference's adaptive
    branch, utils/preprocessing.py:185-188): truncating uint8 codes,
    256-bin histograms of each tile of a ``tile_grid_size`` (width,
    height) grid over the slice extended by reflection to a divisible
    size, clipped with cv2's residual redistribution, one LUT a tile, and
    bilinear interpolation between the four nearest tiles' LUTs. Returns
    fp32 codes / 255. Histograms are int64 sums by ``scatter_add_``, exact
    in any order."""
    x8 = _codes(image)
    n, h, w = x8.shape
    dev = x8.device
    gh, gw = tile_grid_size[1], tile_grid_size[0]
    th, tw = -(-h // gh), -(-w // gw)
    rows = _reflect101(th * gh, h, dev)
    cols = _reflect101(tw * gw, w, dev)
    padded = x8[:, rows][:, :, cols]
    n_tiles, tile_area = gh * gw, th * tw
    tiles = padded.reshape(n, gh, th, gw, tw).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(n, n_tiles, tile_area)

    base = torch.arange(n * n_tiles, device=dev).view(n, n_tiles, 1) * 256
    hist = torch.zeros(n * n_tiles * 256, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, (base + tiles).reshape(-1),
                      torch.ones(1, dtype=torch.int64,
                                 device=dev).expand(tiles.numel()))
    hist = hist.view(n, n_tiles, 256)

    # clip, then cv2's residual redistribution
    clip = max(int(clip_limit * tile_area / 256), 1)
    clipped_amt = (hist - clip).clamp_min(0).sum(-1, keepdim=True)
    hist = hist.clamp_max(clip)
    redist = clipped_amt // 256
    residual = clipped_amt - redist * 256
    hist = hist + redist
    # cv2: step = max(256 // residual, 1); +1 at bins k * step, k < residual
    step = (256 // residual.clamp_min(1)).clamp_min(1)
    bins = torch.arange(256, device=dev)
    hist = hist + ((bins % step == 0) & (bins // step < residual)
                   & (residual > 0)).to(torch.int64)

    lut = torch.round(hist.cumsum(-1).float() * (255.0 / tile_area))
    lut = lut.clamp(0, 255).reshape(n, n_tiles * 256)

    yy = torch.arange(h, dtype=torch.float32, device=dev)
    xx = torch.arange(w, dtype=torch.float32, device=dev)
    tyf = yy / th - 0.5
    txf = xx / tw - 0.5
    ty1 = torch.floor(tyf).to(torch.int64)
    tx1 = torch.floor(txf).to(torch.int64)
    ya = (tyf - ty1)[:, None]
    xa = (txf - tx1)[None, :]
    ty1c = ty1.clamp(0, gh - 1)[:, None]
    ty2c = (ty1 + 1).clamp(0, gh - 1)[:, None]
    tx1c = tx1.clamp(0, gw - 1)[None, :]
    tx2c = (tx1 + 1).clamp(0, gw - 1)[None, :]

    def look(ty, tx):
        idx = (ty * gw + tx) * 256 + x8                      # (n, h, w)
        return torch.gather(lut, 1, idx.reshape(n, -1)).view(n, h, w)

    out = (look(ty1c, tx1c) * (1 - xa) * (1 - ya)
           + look(ty1c, tx2c) * xa * (1 - ya)
           + look(ty2c, tx1c) * (1 - xa) * ya
           + look(ty2c, tx2c) * xa * ya)
    return torch.round(out).clamp(0, 255) / 255.0


@_batched
def histogram_equalization(image: torch.Tensor,
                           n_bins: int = 256) -> torch.Tensor:
    """Global histogram equalization of [0, 1] slices with cv2.equalizeHist's
    LUT rule on the reference's truncating uint8 codes
    (utils/preprocessing.py:181-191): lut = round((cdf - cdf_min) * 255 /
    (total - cdf_min)), cdf_min the count of the first occupied bin.
    Returns fp32 codes / 255."""
    flat = _codes(image).reshape(image.shape[0], -1)
    n, total = flat.shape
    hist = torch.zeros(n, n_bins, dtype=torch.int64, device=flat.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    cdf = hist.cumsum(-1)
    # the first occupied bin (argmax takes no bool tensor)
    first = (hist > 0).to(torch.int32).argmax(-1, keepdim=True)
    cdf_min = torch.gather(cdf, 1, first)
    denom = (total - cdf_min).clamp_min(1)
    lut = torch.round((cdf - cdf_min).float() * 255.0 / denom.float())
    lut = lut.clamp(0, 255).to(torch.uint8)
    return torch.gather(lut, 1, flat).reshape(image.shape).float() / 255.0
