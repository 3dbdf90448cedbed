"""Phase-space (space-to-depth) algebra of the unet's final 2x stage.

An own copy of the JAX package's ``experiments/phase.py`` on NCHW
tensors (``UNetSuperRes(phase_final=True)``, ``models/unet.py``). A
(B, C, 2H, 2W) tensor X is stored as the (B, 4C, H, W) tensor T with

    T[n, 4c + 2a + b, i, j] = X[n, c, 2i + a, 2j + b],   a, b in {0, 1}

the c-major phase order, which is ``nn.PixelShuffle``'s: a conv that
feeds a PixelShuffle already emits phase space.

A 3x3 zero-padded conv W at 2H x 2W is, in phase space, one 2x2 conv over
T with the rescattered kernel

    K2[4co + 2a + b, 4ci + 2u + v, r, s] = W[co, ci, a + 2r + u - 1,
                                              b + 2s + v - 1]

(zero where a tap falls outside [0, 3)). With padding 1 it emits an
(H + 1, W + 1) grid Z where output phase (a, b) of block (i, j) lies at
Z[i + a, j + b] (the "misaligned" layout): :func:`align_phase` slices it
back, or the offsets ride through per-pixel ops and
:func:`depth_to_space_rev_crop` absorbs them at the output.

A GroupNorm with groups of g channels over C at 2H x 2W has groups of 4g
c-major phase channels over 4C at H x W covering the same values, so the
aligned phase norm is GroupNorm over 4C channels with the scale and bias
repeated four times (:func:`phase_group_norm`; on the card the unet runs
it on kernel B1). The misaligned one takes its statistics from the valid
per-phase views only (:func:`phase_group_norm_misaligned`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_superresolution_torch.ops.resize import _align_corners_tensor


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 2H, 2W) -> (B, 4C, H, W), c-major phase channels."""
    return F.pixel_unshuffle(x, 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, H, W) c-major -> (B, C, 2H, 2W): PixelShuffle(2), the
    inverse of :func:`space_to_depth`."""
    return F.pixel_shuffle(x, 2)


def depth_to_space_rev_crop(z: torch.Tensor) -> torch.Tensor:
    """The misaligned (B, 4C, H+1, W+1) grid of a rescattered 2x2 conv
    (phase (a, b) of block (i, j) at Z[i+a, j+b]) straight to the aligned
    (B, C, 2H, 2W) tensor: phase (a, b) placed at sub-position
    (1-a, 1-b) makes the output a uniform +1 shift of the interleave."""
    b, c4, h1, w1 = z.shape
    z = z.reshape(b, c4 // 4, 2, 2, h1, w1).flip(2, 3).reshape(b, c4, h1, w1)
    return F.pixel_shuffle(z, 2)[:, :, 1:2 * h1 - 1, 1:2 * w1 - 1]


def _phase_views(z: torch.Tensor) -> list:
    """The four valid per-phase views (B, C, H, W) of a misaligned grid,
    phase p = 2a + b in turn."""
    h, w = z.shape[2] - 1, z.shape[3] - 1
    return [z[:, (2 * a + bb)::4, a:a + h, bb:bb + w]
            for a in (0, 1) for bb in (0, 1)]


def align_phase(z: torch.Tensor) -> torch.Tensor:
    """Misaligned (B, 4C, H+1, W+1) -> aligned (B, 4C, H, W) c-major."""
    b, c4, h1, w1 = z.shape
    return torch.stack(_phase_views(z), dim=2).reshape(b, c4, h1 - 1, w1 - 1)


def phase_kernel_2x2(w3: torch.Tensor) -> torch.Tensor:
    """A (Co, Ci, 3, 3) conv kernel rescattered into its exact phase-space
    (4Co, 4Ci, 2, 2) equivalent (see the module's note)."""
    co, ci = w3.shape[:2]
    pad = F.pad(w3, (1, 1, 1, 1))                              # (Co,Ci,5,5)
    a = torch.arange(2, device=w3.device)
    # tap index into pad: a + 2r + u (rows), b + 2s + v (columns)
    ar = a[:, None, None] + 2 * a[None, :, None] + a[None, None, :]
    k = pad[:, :, ar[:, :, :, None, None, None],
            ar[None, None, None, :, :, :]]       # (Co, Ci, a, r, u, b, s, v)
    k = k.permute(0, 2, 5, 1, 4, 7, 3, 6)        # (co, a, b, ci, u, v, r, s)
    return k.reshape(4 * co, 4 * ci, 2, 2)


def phase_kernel_1x1(w1: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 1, 1) or (Co, Ci) 1x1 kernel -> the phase-diagonal
    (4Co, 4Ci, 1, 1): phases do not mix under a 1x1 conv."""
    w = w1.reshape(w1.shape[0], w1.shape[1]).contiguous()
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    return torch.kron(w, eye)[:, :, None, None]


def phase_conv_2x2(t: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """The rescattered 2x2 conv over an aligned phase tensor; the result is
    the (B, 4Co, H+1, W+1) misaligned grid."""
    return F.conv2d(t, k2, padding=1)


def upsample_bilinear_phases(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear align_corners=True upsample of (B, C, H, W), emitted in
    aligned phase space (B, 4C, H, W) without the (B, C, 2H, 2W)
    intermediate: the even and odd rows (columns) of the dense upsample's
    matrix, rounded to ``x.dtype`` as the dense path rounds them."""
    b, c, h, w = x.shape
    ah = _align_corners_tensor(h, 2 * h, x.device, x.dtype)
    aw = _align_corners_tensor(w, 2 * w, x.device, x.dtype)
    xn = x.permute(0, 2, 3, 1)                                  # (B,H,W,C)
    parts = []
    for a in (0, 1):
        xr = torch.einsum("oh,bhwc->bowc", ah[a::2], xn)
        for bb in (0, 1):
            parts.append(torch.einsum("pw,bowc->bopc", aw[bb::2], xr))
    t = torch.stack(parts, dim=-1).reshape(b, h, w, 4 * c)
    return t.permute(0, 3, 1, 2)


def _group_stats(views, n_groups: int, n_elems: int):
    """Mean and variance (E[x^2] - mean^2) per (batch, group), fp32, from
    one or more channel views whose groups are c-major channel blocks."""
    s = sq = 0.0
    for v in views:
        g = v.float().reshape(v.shape[0], n_groups, -1)
        s = s + g.sum(dim=2)
        sq = sq + g.square().sum(dim=2)
    mean = s / n_elems
    return mean, sq / n_elems - mean.square()


def _apply_norm(x, mean, var, scale, bias, n_groups, eps, dtype):
    """flax GroupNorm's application: fp32 statistics, the arithmetic in
    the compute dtype, the true channel c's affine on phases 4c..4c+3."""
    b, ch = x.shape[:2]
    reps = ch // n_groups
    mean_c = mean.repeat_interleave(reps, dim=1).reshape(b, ch, 1, 1)
    mul = torch.rsqrt(var + eps)
    mul_c = mul.repeat_interleave(reps, dim=1).reshape(b, ch, 1, 1)
    scale4 = scale.repeat_interleave(4).reshape(1, ch, 1, 1)
    bias4 = bias.repeat_interleave(4).reshape(1, ch, 1, 1)
    y = (x.to(dtype) - mean_c.to(dtype)) * (mul_c.to(dtype) *
                                            scale4.to(dtype))
    return y + bias4.to(dtype)


def phase_group_norm(t: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, n_groups: int, eps: float = 1e-5,
                     dtype=torch.float32) -> torch.Tensor:
    """GroupNorm over an aligned phase tensor (B, 4C, H, W), equal to
    GroupNorm(n_groups) of the (B, C, 2H, 2W) original (the same values a
    group; c-major keeps groups channel-contiguous)."""
    n_elems = t.shape[2] * t.shape[3] * (t.shape[1] // n_groups)
    mean, var = _group_stats([t], n_groups, n_elems)
    return _apply_norm(t, mean, var, scale, bias, n_groups, eps, dtype)


def phase_group_norm_misaligned(z: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, n_groups: int,
                                eps: float = 1e-5,
                                dtype=torch.float32) -> torch.Tensor:
    """GroupNorm over the misaligned (B, 4C, H+1, W+1) grid: statistics of
    the valid per-phase views only (the true tensor's values), then the
    whole grid normalized; its border is cropped later by
    :func:`depth_to_space_rev_crop`, never read."""
    b, c4, h1, w1 = z.shape
    n_elems = (h1 - 1) * (w1 - 1) * (c4 // n_groups)
    mean, var = _group_stats(_phase_views(z), n_groups, n_elems)
    return _apply_norm(z, mean, var, scale, bias, n_groups, eps, dtype)
