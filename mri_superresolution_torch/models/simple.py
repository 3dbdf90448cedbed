"""SimpleSR (``simple``): the SRCNN-style 2x model of the JAX package.

An own port of the JAX package's ``models/simple.py``: a 9-5-5 trunk
(Dong et al.) at the input resolution, ``extract`` 9x9 to f channels,
``map`` 5x5 to f/2, ``reconstruct`` 5x5 to ``out_channels * 4`` (padding
4, 2, 2), ReLU after the first two, PixelShuffle(2) and the sigmoid in
fp32. Every conv is ``F.conv2d`` in the compute dtype; no hand-written
kernel serves the bf16 forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mri_superresolution_torch.models.unet import CL, _conv, kaiming_init_
from mri_superresolution_torch.ops.functional import pixel_shuffle


class SimpleSR(nn.Module):
    """Input: (B, H, W, in_channels) in [0, 1]. Output: (B, 2H, 2W,
    out_channels) in (0, 1), fp32. ``dtype`` is the compute dtype."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        f = base_filters
        self.dtype = dtype
        self.extract = nn.Conv2d(in_channels, f, 9, padding=4)
        self.map = nn.Conv2d(f, f // 2, 5, padding=2)
        self.reconstruct = nn.Conv2d(f // 2, out_channels * 4, 5, padding=2)
        kaiming_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=CL)
        y = F.relu(_conv(x, self.extract.weight, dt, self.extract.bias,
                         padding=4))
        y = F.relu(_conv(y, self.map.weight, dt, self.map.bias, padding=2))
        y = _conv(y, self.reconstruct.weight, dt, self.reconstruct.bias,
                  padding=2)
        y = pixel_shuffle(y, 2)
        return torch.sigmoid(y.float()).permute(0, 2, 3, 1)
