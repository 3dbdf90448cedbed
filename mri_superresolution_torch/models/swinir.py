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
the softmax in fp32.

The served path is the forward with grad off on the card, in what the
window-attention kernel takes (bf16; :func:`SwinIR.served`). There the
attention of each block is one launch of that kernel (``num_blocks *
swin_depth`` a forward, 36 published), and the token stream lies in rows
of Cp = C rounded up to 8 channels (180 -> 184), a 16-byte row of bf16, its
pad channels exactly zero: every GEMM operand and output and every conv's
channels are then 16-byte aligned, which cuBLAS's and cuDNN's Hopper
kernels need (180-wide rows took sm80 ``align2`` GEMM tiles and cuDNN's
padding pass on each conv). The weights are cast into zero-padded bf16
copies on each forward, as the unpadded path casts them, and nothing is
kept on the module. The MLP half of each block there is one launch of
``kernels.swin_mlp`` (LN2, fc1, GELU, fc2 and the residual add; 36 a
forward published), every other LayerNorm ``kernels.padded_layer_norm``
(38 a forward published): both normalise the first C channels with the
fp32 scale and shift as they are (no padded copy) and write the pad as
zeros; the residual adds and the RSTB skip keep zeros at zero, and
``conv_before_upsample`` takes the Cp channels with zero weights on the
pad. Training, the CPU, fp32 and every grad-enabled call take the
unpadded ops. The convs keep cuDNN's bias.

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

from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.kernels.padded_layer_norm import (
    padded_layer_norm)
from mri_superresolution_torch.kernels.swin_mlp import (
    serves as mlp_serves, swin_mlp)
from mri_superresolution_torch.kernels.window_attention import (
    serves, window_attention)
from mri_superresolution_torch.models.unet import CL, _conv, _conv3
from mri_superresolution_torch.ops.functional import pixel_shuffle
from mri_superresolution_torch.utils.spans import span

LN_EPS = 1e-5
LEAKY_SLOPE = 0.01
# channels of one 16-byte vector of bf16: the served path's rows are
# multiples of it
ROW_ALIGN = 8


def row_width(n: int, served: bool) -> int:
    """The channels a row of ``n`` takes: ``n`` rounded up to ROW_ALIGN on
    the served path, ``n`` elsewhere."""
    return -(-n // ROW_ALIGN) * ROW_ALIGN if served else n


def padded(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``t`` cast to ``dtype`` and zero-padded at the end of each axis to
    ``shape``; ``t.to(dtype)`` where the shapes agree."""
    if tuple(shape) == tuple(t.shape):
        return t.to(dtype)
    out = t.new_zeros(shape, dtype=dtype)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _ln(x, norm: nn.LayerNorm, served: bool):
    """LayerNorm over the first C channels in ``x``'s dtype, statistics in
    fp32: on the served path the padded-row kernel, elsewhere PyTorch's own
    over the whole last axis."""
    if served:
        return padded_layer_norm(x, norm.weight, norm.bias, norm.eps)
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _linear(x, lin: nn.Linear, served: bool):
    """``lin`` of ``x``'s rows in x's dtype, its weight zero-padded to x's
    width of inputs and, on the served path, to 16-byte rows of outputs."""
    n = row_width(lin.out_features, served)
    return F.linear(x, padded(lin.weight, (n, x.shape[-1]), x.dtype),
                    padded(lin.bias, (n,), x.dtype))


def _conv_to(x, conv: nn.Conv2d, dtype, n: int):
    """The 3x3 ``conv`` of (B, K, H, W) ``x`` to ``n`` channels, its weight
    zero-padded to K inputs and n outputs, channels_last out."""
    w = padded(conv.weight, (n, x.shape[1]) + tuple(conv.weight.shape[2:]),
               dtype)
    return _conv(x, w, dtype, padded(conv.bias, (n,), dtype), padding=1)


def _conv_tokens(t, conv: nn.Conv2d, dtype, served: bool):
    """A 3x3 conv of (B, H, W, C) tokens, the result as tokens."""
    n = row_width(conv.out_channels, served)
    return _conv_to(t.permute(0, 3, 1, 2), conv, dtype, n).permute(0, 2, 3, 1)


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

    def forward(self, x, served: bool):
        a, c = self.attn, self.norm1.normalized_shape[0]
        with span("swin.attn", x.device):
            qkv = _linear(_ln(x, self.norm1, served), a.qkv, served)
            y = window_attention(qkv, a.relative_position_bias_table,
                                 a.heads, a.window, self.shift, c,
                                 x.shape[-1])
            x = x + _linear(y, a.proj, served)
        m = self.mlp
        with span("swin.mlp", x.device):
            if served and mlp_serves(x.shape[-1], m.fc1.out_features,
                                     x.dtype):
                return swin_mlp(x, self.norm2, m.fc1, m.fc2, c)
            h = F.gelu(_linear(_ln(x, self.norm2, served), m.fc1, served))
            return x + _linear(h, m.fc2, served)


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

    def forward(self, x, dtype, served: bool):
        y = x
        for blk in self.residual_group.blocks:
            y = blk(y, served)
        return x + _conv_tokens(y, self.conv, dtype, served)


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

    def served(self, x: torch.Tensor) -> bool:
        """Whether a forward of ``x`` is the served path: on the card, grad
        off, and every block's attention one that the kernel takes."""
        return x.is_cuda and not _build.needs_grad(x, *self.parameters()) \
            and all(serves(b.norm1.normalized_shape[0], b.attn.heads,
                           b.attn.window, b.shift, self.dtype)
                    for layer in self.layers
                    for b in layer.residual_group.blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x, self.served(x))

    def _forward(self, x: torch.Tensor, served: bool) -> torch.Tensor:
        dt, w = self.dtype, self.window
        _, h0, w0, _ = x.shape
        x = x.permute(0, 3, 1, 2).float()
        ph, pw = (-h0) % w, (-w0) % w
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = x.to(dt).contiguous(memory_format=CL)
        f = _conv_to(x, self.conv_first, dt, row_width(
            self.conv_first.out_channels, served)).permute(0, 2, 3, 1)
        t = _ln(f, self.patch_embed.norm, served)
        for layer in self.layers:
            t = layer(t, dt, served)
        t = _ln(t, self.norm, served)
        y = f + _conv_tokens(t, self.conv_after_body, dt, served)
        y = y.permute(0, 3, 1, 2)
        up = self.conv_before_upsample[0]
        y = F.leaky_relu(_conv_to(y, up, dt, up.out_channels), LEAKY_SLOPE)
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
