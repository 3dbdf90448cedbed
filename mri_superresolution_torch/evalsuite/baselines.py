"""Classical interpolation baselines for comparison against the model.

The port's own copy of the JAX package's ``evalsuite/baselines.py``, the
reference comparator's (scripts/test_comparison.py:92-134):
- ``bilinear``: cv2 INTER_LINEAR 2x upscale,
- ``sharp_bilinear``: bilinear, then the 3x3 sharpen kernel
  [[-1,-1,-1],[-1,9,-1],[-1,-1,-1]] (cv2.filter2D semantics: reflect-101
  border), clipped to [0, 1],
- ``bicubic``: cv2 INTER_CUBIC.

Torch ops on float [0, 1] images, on their device (the reference runs
cv2's uint8 fixed-point path; they agree within 1/255).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_superresolution_torch.ops.resize import Interp, resize

INTERP_METHODS = ("bilinear", "sharp_bilinear", "bicubic")

_SHARPEN = ((-1.0, -1.0, -1.0),
            (-1.0, 9.0, -1.0),
            (-1.0, -1.0, -1.0))


def sharpen3x3(img: torch.Tensor) -> torch.Tensor:
    """cv2.filter2D(img, -1, sharpen_kernel) on the trailing (H, W) axes:
    reflect-101 border, 3x3 kernel, fp32."""
    x = img.float()
    h, w = x.shape[-2:]
    x4 = F.pad(x.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="reflect")
    kern = torch.tensor(_SHARPEN, dtype=torch.float32,
                        device=x.device).view(1, 1, 3, 3)
    return F.conv2d(x4, kern).reshape(x.shape)


def upscale_with_interpolation(img01: torch.Tensor, method: str,
                               scale_factor: int = 2) -> torch.Tensor:
    """Upscale (..., H, W) float [0, 1] images by ``scale_factor``."""
    h, w = img01.shape[-2], img01.shape[-1]
    target = (h * scale_factor, w * scale_factor)
    if method == "bilinear":
        return resize(img01, target, Interp.LINEAR)
    if method == "sharp_bilinear":
        return sharpen3x3(resize(img01, target, Interp.LINEAR)).clamp(0.0,
                                                                       1.0)
    if method == "bicubic":
        return resize(img01, target, Interp.CUBIC)
    raise ValueError(f"Unknown interpolation method: {method}")
