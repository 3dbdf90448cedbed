"""UNetSuperResTPU (``unet_tpu``): the unet's backbone with its final
stage at the input resolution.

An own port of the JAX package's ``models/unet_tpu.py``. The encoder and
decoder are the unet's (``models/unet.backbone``: the same ``DoubleConv``,
``Down`` and ``Up`` modules under the same state_dict names). The final
stage runs at the input resolution with twice the channels and one
depth-to-space at the very end:

- branch A: conv3x3 f -> 2f, GroupNorm + LeakyReLU;
- branch B: conv3x3 f -> 2f with bias and ICNR init, GroupNorm +
  LeakyReLU;
- ``w * a + (1 - w) * b`` with ``w = sigmoid(alpha)`` in the compute
  dtype, then conv3x3 2f -> 2f, GroupNorm + LeakyReLU, a 1x1 conv to
  ``out_channels * 4``, PixelShuffle(2) and the sigmoid in fp32.

Every GroupNorm+LeakyReLU (17 in the backbone, 3 here: 20 a forward) runs
kernel B1 (``kernels.group_norm_leaky``); no conv has the narrow Cout at
2H x 2W that kernel B3 serves, so all convs are ``F.conv2d``. Not weight-
compatible with the unet (use ``unet`` for reference checkpoints).
``remat=True`` recomputes, in the backward, the blocks the JAX package
wraps in ``nn.remat``: the backbone's, both branches and the head
(``models/unet.segment``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mri_superresolution_torch.models.unet import (CL, DoubleConv, Down, Up,
                                                   _conv, _conv3, _gn_leaky,
                                                   _norm, backbone, icnr_,
                                                   kaiming_init_, segment)
from mri_superresolution_torch.ops.functional import pixel_shuffle


class UNetSuperResTPU(nn.Module):
    """Input: (B, H, W, in_channels) in [0, 1]. Output: (B, 2H, 2W,
    out_channels) in (0, 1), fp32. ``dtype`` is the compute dtype."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 32, initial_alpha: float = 0.0,
                 icnr_init: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None, remat: bool = False):
        super().__init__()
        f = base_filters
        self.dtype = dtype
        self.remat = remat
        self.inc = DoubleConv(in_channels, f)
        self.down1 = Down(f, f * 2)
        self.down2 = Down(f * 2, f * 4)
        self.down3 = Down(f * 4, f * 8)
        self.up1 = Up(f * 8, f * 4, f * 4)
        self.up2 = Up(f * 4, f * 2, f * 2)
        self.up3 = Up(f * 2, f, f)
        self.branch_a_conv = _conv3(f, 2 * f)
        self.branch_a_norm = _norm(2 * f)
        self.branch_b_conv = _conv3(f, 2 * f, bias=True)
        self.branch_b_norm = _norm(2 * f)
        self.head_conv = _conv3(2 * f, 2 * f)
        self.head_norm = _norm(2 * f)
        self.head_out = nn.Conv2d(2 * f, out_channels * 4, 1, bias=True)
        # learned fusion weight; initial_alpha is a percentage. Shape (1,),
        # as the unet's, so the functional forwards read both alike
        self.alpha = nn.Parameter(torch.tensor([initial_alpha / 100.0]))
        kaiming_init_(self, generator)
        if icnr_init:
            icnr_(self.branch_b_conv.weight, 2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = backbone(self, x.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=CL), dt)
        a = segment(self, self._branch_a, y)
        b = segment(self, self._branch_b, y)
        w = torch.sigmoid(self.alpha).to(dt).reshape(())
        return segment(self, self._head, w * a + (1.0 - w) * b)

    def _branch_a(self, y):
        return _gn_leaky(_conv(y, self.branch_a_conv.weight, self.dtype,
                               padding=1), self.branch_a_norm)

    def _branch_b(self, y):
        return _gn_leaky(_conv(y, self.branch_b_conv.weight, self.dtype,
                               self.branch_b_conv.bias, padding=1),
                         self.branch_b_norm)

    def _head(self, y):
        dt = self.dtype
        y = _gn_leaky(_conv(y.contiguous(memory_format=CL),
                            self.head_conv.weight, dt, padding=1),
                      self.head_norm)
        y = _conv(y, self.head_out.weight, dt, self.head_out.bias)
        y = pixel_shuffle(y, 2)
        return torch.sigmoid(y.float()).permute(0, 2, 3, 1)
