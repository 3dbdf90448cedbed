"""EDSR (``edsr``): the EDSR-baseline 2x model of the JAX package.

An own port of the JAX package's ``models/edsr.py`` (Lim et al. 2017,
arXiv:1707.02921, for 1-channel [0, 1] MRI slices): a conv head,
``num_blocks`` residual blocks (conv-ReLU-conv, ``x + res_scale * y``), a
global skip around the trunk, a 3x3 tail to ``out_channels * 4``,
PixelShuffle(2) and the sigmoid in fp32. Every conv is ``F.conv2d`` in the
compute dtype; no hand-written kernel serves the bf16 forward. Each
block's second conv starts at zero (the JAX package's residual zero-init:
every block is the identity at init, which keeps an 8-block trunk
trainable), and ``res_scale`` is 1.0, the value the functional forwards
(``models/quant_forward.py``) assume.

``remat=True`` recomputes each ``ResBlock`` in the backward, as the JAX
package wraps each in ``nn.remat`` (``models/unet.segment``).

State_dict names follow the flax tree: ``head``, ``block{i}.conv0`` and
``block{i}.conv1`` (flax ``block{i}/Conv_0``, ``Conv_1``), ``body_out``
and ``tail``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mri_superresolution_torch.models.unet import (CL, _conv, _conv3,
                                                   kaiming_init_, segment)
from mri_superresolution_torch.ops.functional import pixel_shuffle


class ResBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3, added to the input times res_scale."""

    def __init__(self, features: int, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv0 = _conv3(features, features, bias=True)
        self.conv1 = _conv3(features, features, bias=True)

    def forward(self, x, dtype):
        y = F.relu(_conv(x, self.conv0.weight, dtype, self.conv0.bias,
                         padding=1))
        y = _conv(y, self.conv1.weight, dtype, self.conv1.bias, padding=1)
        return x + self.res_scale * y


class EDSR(nn.Module):
    """Input: (B, H, W, in_channels) in [0, 1]. Output: (B, 2H, 2W,
    out_channels) in (0, 1), fp32. ``dtype`` is the compute dtype."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 64, num_blocks: int = 8,
                 res_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None, remat: bool = False):
        super().__init__()
        f = base_filters
        self.dtype = dtype
        self.remat = remat
        self.num_blocks = num_blocks
        self.head = _conv3(in_channels, f, bias=True)
        for i in range(num_blocks):
            self.add_module(f"block{i}", ResBlock(f, res_scale))
        self.body_out = _conv3(f, f, bias=True)
        self.tail = _conv3(f, out_channels * 4, bias=True)
        kaiming_init_(self, generator)
        with torch.no_grad():
            for i in range(num_blocks):
                getattr(self, f"block{i}").conv1.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=CL)
        head = _conv(x, self.head.weight, dt, self.head.bias, padding=1)
        y = head
        for i in range(self.num_blocks):
            y = segment(self, getattr(self, f"block{i}"), y, dt)
        y = _conv(y, self.body_out.weight, dt, self.body_out.bias, padding=1)
        y = _conv(y + head, self.tail.weight, dt, self.tail.bias, padding=1)
        y = pixel_shuffle(y, 2)
        return torch.sigmoid(y.float()).permute(0, 2, 3, 1)
