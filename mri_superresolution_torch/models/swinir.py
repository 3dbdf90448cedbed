"""SwinIR (``swinir``): the classical-SR Swin transformer of Liang et al.
2021 (arXiv:2108.10257), ``models/network_swinir.py`` of the published code
with the settings of ``main_test_swinir.py --task classical_sr --scale 2``:
``upsampler="pixelshuffle"``, ``resi_connection="1conv"``, ``ape=False``,
``patch_norm=True``, ``qkv_bias=True``, ``img_range=1``, mean 0 at one
channel. The widths come from :class:`~mri_superresolution_torch.config.
ModelConfig`: ``base_filters`` is ``embed_dim`` (180 published),
``num_blocks`` the residual Swin groups (RSTBs, 6), ``swin_depth`` the Swin
blocks of each (6), ``swin_heads`` (6), ``window_size`` (8, shift
window_size // 2 on every odd block), ``mlp_ratio`` (2.0) and ``num_feat``
(64).

Each Swin block is ``x + proj(WA(LN1(x)))``, then ``x + fc2(GELU(fc1(LN2(x))))``
with the exact GELU, where WA is the window attention of
``kernels.window_attention``. Each RSTB is ``x + conv3x3(blocks(x))``. The
whole: a reflect pad of the input to a multiple of the window, ``f =
conv_first(x)``, ``f + conv_after_body(LN(RSTBs(LN_patch(f))))``, a conv to
``num_feat`` and LeakyReLU(0.01), a conv to 4 ``num_feat`` and
PixelShuffle(2), ``conv_last``, and the crop to 2H x 2W.

Tensors are (B, H, W, C) tokens between the convs, which see the same bytes
as (B, C, H, W) in channels_last memory. Params are fp32 and every op runs
in the compute ``dtype`` (bf16 served), LayerNorm with its statistics and
the softmax in fp32. With grad off on the card, in bf16, the attention of
each block is one launch of the window-attention kernel (``num_blocks *
swin_depth`` a forward, 36 published); training, the CPU and fp32 take its
plain version. The convs keep cuDNN's bias: 180 channels is no multiple of
``kernels.bias_epilogue``'s vector.

The state_dict names are the published ones, so a published ``.pth``
(``params``) loads once its two buffers per block (``relative_position_index``
and ``attn_mask``) are dropped; here both are derived from coordinates and
not kept in the state_dict. Each block's halves are the spans ``swin.attn``
and ``swin.mlp`` (``utils/spans.py``), timed on the card.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mri_superresolution_torch.kernels.window_attention import (
    window_attention)
from mri_superresolution_torch.models.unet import CL, _conv, _conv3
from mri_superresolution_torch.ops.functional import pixel_shuffle
from mri_superresolution_torch.utils.spans import span

LN_EPS = 1e-5
LEAKY_SLOPE = 0.01


def _ln(x, norm: nn.LayerNorm):
    """LayerNorm over the last axis in ``x``'s dtype, statistics in fp32
    (PyTorch's own, for bf16 too)."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _linear(x, lin: nn.Linear):
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _conv_tokens(t, conv: nn.Conv2d, dtype):
    """A 3x3 conv of (B, H, W, C) tokens, the result as tokens."""
    return _conv(t.permute(0, 3, 1, 2), conv.weight, dtype, conv.bias,
                 padding=1).permute(0, 2, 3, 1)


class WindowAttention(nn.Module):
    """The published module's params: ``qkv``, ``proj`` and the
    relative-position bias table ((2w - 1)^2, heads). Its index and the
    shifted blocks' mask, the published buffers, come from coordinates
    (``kernels.window_attention``)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim, bias=True)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        a = self.attn
        with span("swin.attn", x.device):
            qkv = _linear(_ln(x, self.norm1), a.qkv)
            y = window_attention(qkv, a.relative_position_bias_table,
                                 a.heads, a.window, self.shift)
            x = x + _linear(y, a.proj)
        with span("swin.mlp", x.device):
            h = F.gelu(_linear(_ln(x, self.norm2), self.mlp.fc1))
            x = x + _linear(h, self.mlp.fc2)
        return x


class ResidualGroup(nn.Module):
    """The published ``BasicLayer``: ``depth`` Swin blocks, the odd ones
    shifted by window // 2."""

    def __init__(self, dim, depth, heads, window, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2,
                      mlp_ratio) for i in range(depth))


class RSTB(nn.Module):
    """A residual Swin transformer block: ``x + conv3x3(blocks(x))``."""

    def __init__(self, dim, depth, heads, window, mlp_ratio):
        super().__init__()
        self.residual_group = ResidualGroup(dim, depth, heads, window,
                                            mlp_ratio)
        self.conv = _conv3(dim, dim, bias=True)

    def forward(self, x, dtype):
        y = x
        for blk in self.residual_group.blocks:
            y = blk(y)
        return x + _conv_tokens(y, self.conv, dtype)


class PatchNorm(nn.Module):
    """The published ``PatchEmbed`` with ``patch_norm``: its LayerNorm."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class SwinIR(nn.Module):
    """Input: (B, H, W, in_channels) in [0, 1]. Output: (B, 2H, 2W,
    out_channels), fp32, unbounded (no output activation, as published).
    ``dtype`` is the compute dtype."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 embed_dim: int = 180, num_layers: int = 6, depth: int = 6,
                 heads: int = 6, window: int = 8, mlp_ratio: float = 2.0,
                 num_feat: int = 64, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        self.dtype, self.window = dtype, window
        d = embed_dim
        self.conv_first = nn.Conv2d(in_channels, d, 3, padding=1)
        self.patch_embed = PatchNorm(d)
        self.layers = nn.ModuleList(
            RSTB(d, depth, heads, window, mlp_ratio)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.conv_after_body = _conv3(d, d, bias=True)
        self.conv_before_upsample = nn.Sequential(
            _conv3(d, num_feat, bias=True), nn.LeakyReLU(LEAKY_SLOPE))
        self.upsample = nn.Sequential(_conv3(num_feat, 4 * num_feat,
                                             bias=True), nn.PixelShuffle(2))
        self.conv_last = _conv3(num_feat, out_channels, bias=True)
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, w = self.dtype, self.window
        _, h0, w0, _ = x.shape
        x = x.permute(0, 3, 1, 2).float()
        ph, pw = (-h0) % w, (-w0) % w
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = x.to(dt).contiguous(memory_format=CL)
        f = _conv(x, self.conv_first.weight, dt, self.conv_first.bias,
                  padding=1).permute(0, 2, 3, 1)
        t = _ln(f, self.patch_embed.norm)
        for layer in self.layers:
            t = layer(t, dt)
        t = _ln(t, self.norm)
        y = f + _conv_tokens(t, self.conv_after_body, dt)
        y = y.permute(0, 3, 1, 2)
        up = self.conv_before_upsample[0]
        y = F.leaky_relu(_conv(y, up.weight, dt, up.bias, padding=1),
                         LEAKY_SLOPE)
        ups = self.upsample[0]
        y = pixel_shuffle(_conv(y, ups.weight, dt, ups.bias, padding=1), 2)
        y = _conv(y, self.conv_last.weight, dt, self.conv_last.bias,
                  padding=1)
        return y[:, :, :2 * h0, :2 * w0].float().permute(0, 2, 3, 1)


@torch.no_grad()
def _init_(model: nn.Module, generator: torch.Generator = None) -> None:
    """The published init, drawn from ``generator`` in module order: every
    Linear weight and bias table trunc_normal(std 0.02), Linear biases 0,
    LayerNorms 1 and 0; convs Kaiming uniform (PyTorch's default, a = 5^0.5)
    with a zero bias."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5,
                                     generator=generator)
            m.bias.zero_()
        elif isinstance(m, WindowAttention):
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                  generator=generator)
