"""The single-slice preprocessing orchestrator.

The port's own copy of the JAX package's ``ops/pipeline.py``, which mirrors
the reference ``preprocess_slice`` (utils/preprocessing.py:295-374) option
for option: manual or percentile auto-windowing, min-max normalization,
optional k-space low-field simulation, optional adaptive histogram
equalization (CLAHE), and letterbox, crop, stretch or pad resizing. Every
op runs on the slice's device.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from mri_superresolution_torch.ops.kspace import (draw_kspace_noise,
                                                  simulate_low_field_mri)
from mri_superresolution_torch.ops.normalize import (_percentile_weights,
                                                     apply_windowing, clahe,
                                                     minmax_normalize)
from mri_superresolution_torch.ops.resize import (Interp, center_crop,
                                                  letterbox_resize,
                                                  pad_to_size, resize)


class ResizeMethod(enum.Enum):
    """Reference utils/preprocessing.py:8-13."""
    LETTERBOX = "letterbox"
    CROP = "crop"
    STRETCH = "stretch"
    PAD = "pad"


def _slice_percentiles(x: torch.Tensor, lower: float, upper: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``normalize._percentiles`` of a (1, h, w) slice, rounded as a single
    slice's ``jnp.percentile``: XLA fuses the second product into the sum
    there, where a batch's fuses the first (one fp32 ulp apart at most)."""
    s = torch.sort(x.reshape(1, -1).float(), dim=1).values
    out = []
    for q in (lower, upper):
        low, high, w_low, w_high = _percentile_weights(q, s.shape[1])
        v = ((s[:, low] * w_low).double()
             + s[:, high].double() * w_high).float()
        out.append(v[:, None, None])
    return out[0], out[1]


def preprocess_slice(slice_data: torch.Tensor,
                     target_size: Optional[Tuple[int, int]] = None,
                     interpolation: Interp = Interp.CUBIC,
                     equalize: bool = False,
                     window_center: Optional[float] = None,
                     window_width: Optional[float] = None,
                     min_percentile: float = 0.5,
                     max_percentile: float = 99.5,
                     resize_method: ResizeMethod = ResizeMethod.LETTERBOX,
                     apply_simulation: bool = False,
                     noise_std: float = 5.0,
                     pad_value: float = 0.0,
                     kspace_crop_factor: float = 0.5,
                     noise: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None
                     ) -> torch.Tensor:
    """One (H, W) slice -> fp32 in [0, 1] (reference parity).
    ``target_size`` is (width, height). ``noise`` is the simulation's
    (real, imaginary) unscaled draw (``ops/kspace.draw_kspace_noise``);
    None draws it from a generator seeded 0 on the slice's device, as the
    JAX package falls back to ``jax.random.key(0)`` (not its bits)."""
    x = slice_data.float()[None]

    # windowing: manual or percentile auto (utils/preprocessing.py:331-338)
    if window_center is not None and window_width is not None:
        x = apply_windowing(x, window_center, window_width)
    else:
        lo, hi = _slice_percentiles(x, min_percentile, max_percentile)
        x = torch.minimum(torch.maximum(x, lo), hi)

    x = minmax_normalize(x)

    if apply_simulation:
        if noise is None:
            noise = draw_kspace_noise(x.shape, torch.Generator(
                device=x.device).manual_seed(0))
        x = simulate_low_field_mri(x, noise, kspace_crop_factor, noise_std)
        x = x.clamp(0.0, 1.0)

    if equalize:  # the reference always takes the adaptive (CLAHE) variant
        x = clahe(x)

    if target_size:
        if resize_method == ResizeMethod.LETTERBOX:
            x = letterbox_resize(x, target_size, interpolation, pad_value)
        elif resize_method == ResizeMethod.CROP:
            x = center_crop(x, target_size)
        elif resize_method == ResizeMethod.PAD:
            x = pad_to_size(x, target_size, pad_value)
        elif resize_method == ResizeMethod.STRETCH:
            tw, th = target_size
            x = resize(x, (th, tw), interpolation)
        else:  # letterbox on the larger side (utils/preprocessing.py:370-372)
            md = max(target_size)
            x = letterbox_resize(x, (md, md), interpolation, pad_value)
    return x[0]
