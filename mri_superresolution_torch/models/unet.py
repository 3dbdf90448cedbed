"""U-Net for 2x MRI super-resolution, PyTorch, bf16-ready.

The topology of the reference ``UNetSuperRes`` (models/unet_model.py:
116-211) as the JAX package builds it: three maxpool Down stages, three
bilinear Up stages with skip concatenation, a dual-branch final 2x upsample
(bilinear + conv against PixelShuffle) fused by a learned ``sigmoid(alpha)``,
and a sigmoid-bounded one-channel output.

- The public forward takes (B, H, W, 1) and returns (B, 2H, 2W, 1) fp32,
  the JAX layout. Inside, tensors are NCHW-indexed in ``channels_last``
  memory, so the kernels see NHWC bytes and cuDNN takes its NHWC path.
- Params are fp32; ``dtype`` is the compute dtype (bf16 for serving), and
  weights are cast to it at each use, as flax ``dtype=`` does. The output
  sigmoid runs in fp32.
- Every GroupNorm+LeakyReLU (20 per forward) runs through kernel B1
  (``kernels.group_norm_leaky``); ``final_up_conv`` and ``final_conv1``,
  the Cout = f/2 3x3 convs at 2H x 2W, run through kernel B3
  (``kernels.conv3x3``). The other convs are ``F.conv2d``.
- ``remat=True`` (the train CLI's ``--remat``) recomputes the blocks
  the JAX package wraps in ``nn.remat`` in the backward instead of
  keeping their activations (:func:`segment`): ``inc``, the Downs and
  Ups, ``final_up_pixelshuffle``, the bilinear branch and the head. The
  parameters are unchanged, so checkpoints do not depend on it.
- ``phase_final=True`` computes the final 2x stage in phase space at
  H x W (``experiments/phase.py``, the JAX package's
  ``_final_stage_phase``), with the same state_dict: the 3x3 convs at
  2H x 2W become rescattered 2x2 convs (cuDNN; no B3), and the two
  aligned phase-space norms, the bilinear branch's and
  ``PixelShuffleUp``'s, are GroupNorm(8) over the 4 x f/2 c-major phase
  channels with scale and bias repeated four times: kernel B1 with its
  LeakyReLU. The misaligned norm after ``final_conv1`` stays in torch
  ops, as JAX's is ``jnp`` views outside any Pallas kernel. As in JAX,
  ``remat`` does not segment that stage.
- Module and parameter names are the reference's state_dict keys, so a
  reference ``.pth`` loads strictly. The ``nn.Sequential`` containers only
  hold the parameters under those keys; the forward calls the functions
  itself and never runs a container.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from mri_superresolution_torch.experiments import phase
from mri_superresolution_torch.kernels import conv3x3, group_norm_leaky
from mri_superresolution_torch.ops.functional import max_pool2, pixel_shuffle
from mri_superresolution_torch.ops.resize import upsample_bilinear_align_corners

CL = torch.channels_last
# Kaiming He normal, mode='fan_out', nonlinearity='leaky_relu' with torch's
# default negative_slope param (0.01): gain^2 = 2 / (1 + 0.01^2)
_KAIMING_A = 0.01


def _conv(x, weight, dtype, bias=None, padding=0):
    """``F.conv2d`` in the compute dtype, channels_last out."""
    y = F.conv2d(x, weight.to(dtype),
                 None if bias is None else bias.to(dtype), padding=padding)
    return y.contiguous(memory_format=CL)


def _gn_leaky(x, norm: nn.GroupNorm, residual=None):
    return group_norm_leaky(x, norm.weight, norm.bias, residual=residual,
                            n_groups=norm.num_groups, eps=norm.eps)


def _phase_gn_leaky(t, norm: nn.GroupNorm):
    """``norm`` + LeakyReLU(0.2) of the (B, 4C, H, W) aligned phase form of
    a (B, C, 2H, 2W) tensor (``experiments/phase.phase_group_norm``): the
    same groups over 4C channels, the affine repeated 4x, on kernel B1."""
    return group_norm_leaky(t.contiguous(memory_format=CL),
                            norm.weight.repeat_interleave(4),
                            norm.bias.repeat_interleave(4),
                            n_groups=norm.num_groups, eps=norm.eps)


def _upsample2(x):
    """Bilinear 2x (align_corners) through the NHWC view of a
    channels_last tensor; the result is channels_last again."""
    return upsample_bilinear_align_corners(x.permute(0, 2, 3, 1), 2).permute(
        0, 3, 1, 2)


def segment(m: nn.Module, fn, *args):
    """``fn(*args)``; with ``m.remat`` set and gradients on, as one
    rematerialized segment (``torch.utils.checkpoint``, non-reentrant):
    the backward runs the segment's forward again instead of keeping its
    activations, the counterpart of the JAX package's ``nn.remat``. The
    autograd graph is the one without it, so the gradients are the same
    bits. The recomputation stops once the last tensor the backward needs
    is saved (PyTorch's early stop), but each kernel's
    ``autograd.Function`` saves its inputs only when its forward returns,
    so every kernel of a segment runs again: a unet step launches B1 and
    B3 twice over."""
    if getattr(m, "remat", False) and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _conv3(cin, cout, bias=False):
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


def _norm(c):
    return nn.GroupNorm(8, c, eps=1e-5)


@torch.no_grad()
def kaiming_init_(module: nn.Module, generator: torch.Generator = None
                  ) -> None:
    """Kaiming fan_out normal for every conv of ``module`` (the JAX
    package's ``kaiming_fan_out``), zero biases, unit GroupNorm scales,
    drawn from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, a=_KAIMING_A, mode="fan_out",
                                    nonlinearity="leaky_relu",
                                    generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


@torch.no_grad()
def icnr_(weight: torch.Tensor, scale: int = 2,
          generator: torch.Generator = None) -> None:
    """ICNR (the JAX package's ``icnr_kaiming_fan_in``): a Kaiming fan_in
    kernel of Cout/scale² channels, each repeated scale² times, so the
    PixelShuffle after the conv starts as a nearest-neighbour upsample."""
    r2 = scale ** 2
    base = torch.empty((weight.shape[0] // r2,) + tuple(weight.shape[1:]))
    nn.init.kaiming_normal_(base, a=_KAIMING_A, mode="fan_in",
                            nonlinearity="leaky_relu", generator=generator)
    weight.copy_(base.repeat_interleave(r2, dim=0))


class DoubleConv(nn.Module):
    """(Conv3x3 -> GroupNorm(8) -> LeakyReLU(0.2)) x2, residual when channels
    match (reference models/unet_model.py:17-45)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.double_conv = nn.Sequential(
            _conv3(in_channels, out_channels), _norm(out_channels),
            nn.LeakyReLU(0.2), _conv3(out_channels, out_channels),
            _norm(out_channels), nn.LeakyReLU(0.2))

    def forward(self, x, dtype):
        conv1, norm1, _, conv2, norm2, _ = self.double_conv
        y = _gn_leaky(_conv(x, conv1.weight, dtype, padding=1), norm1)
        res = x if self.in_channels == self.out_channels else None
        return _gn_leaky(_conv(y, conv2.weight, dtype, padding=1), norm2, res)


class Down(nn.Module):
    """MaxPool(2) then DoubleConv (reference models/unet_model.py:47-57)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x, dtype):
        x = max_pool2(x).contiguous(memory_format=CL)
        return self.maxpool_conv[1](x, dtype)


class Up(nn.Module):
    """1x1 conv halving channels, bilinear 2x (align_corners), pad-to-match,
    skip concat, DoubleConv (reference models/unet_model.py:59-94).

    The 1x1 conv runs BEFORE the upsample: the two commute exactly (both
    linear, on disjoint axes), and the conv then sees a quarter of the
    pixels. GroupNorm stays after the upsample."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int):
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(in_channels, in_channels // 2, 1, bias=False),
            _norm(in_channels // 2), nn.LeakyReLU(0.2))
        self.conv = DoubleConv(skip_channels + in_channels // 2, out_channels)

    def forward(self, x1, x2, dtype):
        _, up_conv, up_norm, _ = self.up
        x1 = _gn_leaky(_upsample2(_conv(x1, up_conv.weight, dtype)), up_norm)
        # zero pad to the skip's size, split left/right like torch F.pad
        dy = x2.shape[2] - x1.shape[2]
        dx = x2.shape[3] - x1.shape[3]
        if dy or dx:
            x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        x = torch.cat([x2, x1], dim=1).contiguous(memory_format=CL)
        return self.conv(x, dtype)


class PixelShuffleUp(nn.Module):
    """Conv3x3 -> PixelShuffle(scale) -> GroupNorm(8) -> LeakyReLU(0.2)
    (reference models/unet_model.py:96-114)."""

    def __init__(self, in_channels: int, out_channels: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = _conv3(in_channels, out_channels * scale ** 2, bias=True)
        self.norm = _norm(out_channels)

    def forward(self, x, dtype, phase_out: bool = False):
        """``phase_out``: the conv's output, in PixelShuffle's channel
        order, already is the c-major phase space of the shuffled tensor:
        skip the shuffle and normalize there (the same statistics)."""
        x = _conv(x, self.conv.weight, dtype, self.conv.bias, padding=1)
        if phase_out:
            return _phase_gn_leaky(x, self.norm)
        x = pixel_shuffle(x, self.scale).contiguous(memory_format=CL)
        return _gn_leaky(x, self.norm)


def backbone(m: nn.Module, x: torch.Tensor, dtype) -> torch.Tensor:
    """The encoder-decoder of ``unet`` and ``unet_tpu``: ``m.inc``, three
    Downs and three Ups with skips, on an NCHW-indexed channels_last
    ``x``; 17 GroupNorm+LeakyReLU sites. Each block is a segment of its
    own under ``m.remat``."""
    x1 = segment(m, m.inc, x, dtype)
    x2 = segment(m, m.down1, x1, dtype)
    x3 = segment(m, m.down2, x2, dtype)
    x4 = segment(m, m.down3, x3, dtype)
    y = segment(m, m.up1, x4, x3, dtype)
    y = segment(m, m.up2, y, x2, dtype)
    return segment(m, m.up3, y, x1, dtype)


class UNetSuperRes(nn.Module):
    """2x super-resolution U-Net (reference models/unet_model.py:116-211).

    Input: (B, H, W, in_channels) in [0, 1]. Output: (B, 2H, 2W,
    out_channels) in (0, 1), fp32. ``dtype`` is the compute dtype;
    ``remat`` recomputes the JAX package's remat blocks in the backward;
    ``phase_final`` computes the final stage in phase space (the same
    parameters, so checkpoints do not depend on it).
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 base_filters: int = 32, initial_alpha: float = 0.0,
                 icnr_init: bool = False, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None, remat: bool = False,
                 phase_final: bool = False):
        super().__init__()
        f = base_filters
        self.dtype = dtype
        self.remat = remat
        self.phase_final = phase_final
        self.inc = DoubleConv(in_channels, f)
        self.down1 = Down(f, f * 2)
        self.down2 = Down(f * 2, f * 4)
        self.down3 = Down(f * 4, f * 8)
        self.up1 = Up(f * 8, f * 4, f * 4)
        self.up2 = Up(f * 4, f * 2, f * 2)
        self.up3 = Up(f * 2, f, f)
        self.final_up_bilinear = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            _conv3(f, f // 2), _norm(f // 2), nn.LeakyReLU(0.2))
        self.final_up_pixelshuffle = PixelShuffleUp(f, f // 2)
        self.final_conv = nn.Sequential(
            _conv3(f // 2, f // 2), _norm(f // 2), nn.LeakyReLU(0.2),
            nn.Conv2d(f // 2, out_channels, 1, bias=True))
        # learned fusion weight; initial_alpha is a percentage
        self.alpha = nn.Parameter(torch.tensor([initial_alpha / 100.0]))
        self.reset_parameters(icnr_init, generator)

    def reset_parameters(self, icnr_init: bool = False,
                         generator: torch.Generator = None) -> None:
        """Kaiming fan_out normal for every conv (the reference's
        ``_initialize_weights``), zero biases, unit GroupNorm scales; with
        ``icnr_init`` the PixelShuffle conv takes ICNR instead."""
        kaiming_init_(self, generator)
        if icnr_init:
            ps = self.final_up_pixelshuffle
            icnr_(ps.conv.weight, ps.scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = backbone(self, x.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=CL), dt)
        if self.phase_final:
            return self._final_stage_phase(y)

        # dual-branch final 2x upsample; each branch and the head a
        # segment of its own under remat, as in the JAX package
        yb = segment(self, self._bilinear_branch, y)
        yp = segment(self, self.final_up_pixelshuffle, y, dt)
        w = torch.sigmoid(self.alpha).to(dt).reshape(())
        return segment(self, self._final_head, w * yb + (1.0 - w) * yp)

    def _bilinear_branch(self, y):
        _, up_conv, up_norm, _ = self.final_up_bilinear
        up_w = up_conv.weight.to(self.dtype, memory_format=CL)
        return _gn_leaky(conv3x3(_upsample2(y), up_w), up_norm)

    def _final_head(self, y):
        dt = self.dtype
        conv1, norm, _, conv2 = self.final_conv
        y = _gn_leaky(conv3x3(y.contiguous(memory_format=CL),
                              conv1.weight.to(dt, memory_format=CL)), norm)
        y = _conv(y, conv2.weight, dt, conv2.bias)
        return torch.sigmoid(y.float()).permute(0, 2, 3, 1)

    def _final_stage_phase(self, y):
        """The dual-branch final 2x stage at y's resolution in c-major
        phase space (the JAX package's ``_final_stage_phase``): the same
        function as the dense path, its Cout = f/2 convs at 2H x 2W
        replaced by Cout = 2f convs at H x W."""
        dt = self.dtype
        _, up_conv, up_norm, _ = self.final_up_bilinear
        conv1, norm, _, conv2 = self.final_conv

        # bilinear branch: phase-space upsample, rescattered 2x2 conv,
        # the norm on the re-aligned grid
        t_up = phase.upsample_bilinear_phases(y)               # (B,4f,H,W)
        z_up = phase.phase_conv_2x2(
            t_up, phase.phase_kernel_2x2(up_conv.weight).to(dt))
        yb = _phase_gn_leaky(phase.align_phase(z_up), up_norm)  # (B,2f,H,W)
        # PixelShuffle branch: its conv's output already is phase space
        yp = self.final_up_pixelshuffle(y, dt, phase_out=True)
        w = torch.sigmoid(self.alpha).to(dt).reshape(())
        t = w * yb + (1.0 - w) * yp

        # final_conv1 stays misaligned through the per-pixel tail; the
        # offsets are absorbed by depth_to_space_rev_crop at the end
        z1 = phase.phase_conv_2x2(
            t, phase.phase_kernel_2x2(conv1.weight).to(dt))  # (B,2f,H+1,W+1)
        z1 = F.leaky_relu(phase.phase_group_norm_misaligned(
            z1, norm.weight, norm.bias, norm.num_groups, norm.eps, dt), 0.2)
        z2 = F.conv2d(z1, phase.phase_kernel_1x1(conv2.weight).to(dt)) + \
            conv2.bias.repeat_interleave(4).to(dt).view(1, -1, 1, 1)
        return phase.depth_to_space_rev_crop(
            torch.sigmoid(z2.float())).permute(0, 2, 3, 1)


def param_count(model: nn.Module) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())
