"""K-space low-field MRI simulation of a batch of slices, on ``torch.fft``.

The port's own copy of the JAX package's ``ops/kspace.py``, the math of the
reference's ``simulate_low_field_mri`` (utils/preprocessing.py:225-293):
FFT2 -> fftshift -> keep a centred rectangle covering
``kspace_crop_factor`` of each axis -> add complex Gaussian noise with std
``(noise_std / 255) * sqrt(rows * cols) / 10`` -> ifftshift -> IFFT2 ->
magnitude (Rician noise) -> min-max rescale back to each slice's range.

The noise draw is split from the transform, as ``ops/augment.py`` splits
its draws: :func:`draw_kspace_noise` draws the two unscaled normal tensors
from an explicit ``torch.Generator`` on the slices' device, and
:func:`simulate_low_field_mri` takes them as arguments. The draws are
distributed as JAX's ``jax.random.normal`` pair, not the same bits: tests
rebuild JAX's draws from its key and pass them in.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _center_mask(rows: int, cols: int, crop_factor: float) -> np.ndarray:
    """The centred-rectangle keep mask (reference utils/preprocessing.py:
    261-269)."""
    center_row, center_col = rows // 2, cols // 2
    crop_r = int(rows * crop_factor)
    crop_c = int(cols * crop_factor)
    mask = np.zeros((rows, cols), dtype=np.float32)
    r0, r1 = center_row - crop_r // 2, center_row + crop_r // 2
    c0, c1 = center_col - crop_c // 2, center_col + crop_c // 2
    mask[r0:r1, c0:c1] = 1.0
    return mask


def draw_kspace_noise(shape: Tuple[int, ...], generator: torch.Generator
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The real and imaginary unscaled N(0, 1) fp32 draws of
    :func:`simulate_low_field_mri` for a ``shape`` batch of slices, on the
    generator's device."""
    dev = generator.device
    real = torch.randn(shape, generator=generator, device=dev)
    imag = torch.randn(shape, generator=generator, device=dev)
    return real, imag


def simulate_low_field_mri(data: torch.Tensor,
                           noise: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                           kspace_crop_factor: float = 0.5,
                           noise_std: float = 5.0) -> torch.Tensor:
    """Simulate low-field MRI on (B, H, W) or (H, W) fp32 slices.

    ``noise`` is the (real, imaginary) pair of unscaled draws shaped like
    the batch (:func:`draw_kspace_noise`), scaled here by the reference's
    rule (utils/preprocessing.py:274); None adds no noise. Each slice is
    min-max rescaled back to its own [min, max].
    """
    squeeze = data.dim() == 2
    x = (data[None] if squeeze else data).float()
    b, rows, cols = x.shape

    orig_min = x.amin(dim=(1, 2), keepdim=True)
    orig_max = x.amax(dim=(1, 2), keepdim=True)

    kspace = torch.fft.fftshift(torch.fft.fft2(x), dim=(1, 2))
    mask = torch.from_numpy(_center_mask(rows, cols, kspace_crop_factor))
    kspace = kspace * mask.to(x.device)
    if noise is not None:
        scaled = (noise_std / 255.0) * np.sqrt(rows * cols) / 10.0
        real, imag = noise
        kspace = kspace + torch.complex(
            real.reshape(b, rows, cols) * scaled,
            imag.reshape(b, rows, cols) * scaled)

    magnitude = torch.fft.ifft2(
        torch.fft.ifftshift(kspace, dim=(1, 2))).abs()
    mag_min = magnitude.amin(dim=(1, 2), keepdim=True)
    mag_max = magnitude.amax(dim=(1, 2), keepdim=True)
    simulated = (magnitude - mag_min) / (mag_max - mag_min).clamp_min(1e-12)
    simulated = simulated * (orig_max - orig_min) + orig_min
    return simulated[0] if squeeze else simulated
