"""Operations and bytes of the work the cells time, from shapes alone, and
the card's published peaks.

The FLOP counts are the architectures' convolutions, 2 * H * W * kh * kw *
Cin * Cout a conv, with no implementation overhead (upsample matmuls,
GroupNorms, the phase-space rescatter): a count that stays comparable
across implementations. The byte counts of kernel B1 (GroupNorm +
LeakyReLU) read each input once and write each output once.
"""

from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def _conv(px: int, k: int, cin: int, cout: int) -> int:
    return 2 * px * k * k * cin * cout


def unet_flops_per_slice(h: int, w: int, f: int = 32) -> int:
    """Conv FLOPs of the parity U-Net (rdd0582/mri_superresolution,
    models/unet_model.py:116-211) for one (h, w) input slice, 2x out."""
    n = h * w
    total = _conv(n, 3, 1, f) + _conv(n, 3, f, f)
    total += _conv(n // 4, 3, f, 2 * f) + _conv(n // 4, 3, 2 * f, 2 * f)
    total += _conv(n // 16, 3, 2 * f, 4 * f) + _conv(n // 16, 3, 4 * f, 4 * f)
    total += _conv(n // 64, 3, 4 * f, 8 * f) + _conv(n // 64, 3, 8 * f, 8 * f)
    # Ups: 1x1 channel halving, then the DoubleConv over the concat
    total += (_conv(n // 16, 1, 8 * f, 4 * f) + _conv(n // 16, 3, 8 * f, 4 * f)
              + _conv(n // 16, 3, 4 * f, 4 * f))
    total += (_conv(n // 4, 1, 4 * f, 2 * f) + _conv(n // 4, 3, 4 * f, 2 * f)
              + _conv(n // 4, 3, 2 * f, 2 * f))
    total += (_conv(n, 1, 2 * f, f) + _conv(n, 3, 2 * f, f)
              + _conv(n, 3, f, f))
    # final 2x stage: bilinear branch conv and head at 2h x 2w, the
    # PixelShuffle branch's conv at h x w
    total += _conv(4 * n, 3, f, f // 2)
    total += _conv(n, 3, f, 2 * f)
    total += _conv(4 * n, 3, f // 2, f // 2)
    total += _conv(4 * n, 1, f // 2, 1)
    return total


def edsr_flops_per_slice(h: int, w: int, f: int = 64, blocks: int = 16,
                         scale: int = 2) -> int:
    """Conv FLOPs of EDSR (Lim et al. 2017) with one input and one output
    channel for one (h, w) slice: head, 2 convs a residual block, the
    trunk's closing conv and the tail to scale^2 channels."""
    n = h * w
    return (_conv(n, 3, 1, f) + 2 * blocks * _conv(n, 3, f, f)
            + _conv(n, 3, f, f) + _conv(n, 3, f, scale * scale))


def unet_b1_sites(h: int, w: int, f: int = 32) -> list:
    """(channels, pixels, has_residual) of each of the parity U-Net's 20
    GroupNorm + LeakyReLU sites for an (h, w) input: two a DoubleConv,
    one after each Up's channel halving, three in the final stage. No
    DoubleConv of this U-Net keeps its channel count, so none adds a
    residual."""
    n = h * w
    sites = [(f, n)] * 2                                     # inc
    sites += [(2 * f, n // 4)] * 2 + [(4 * f, n // 16)] * 2 \
        + [(8 * f, n // 64)] * 2                             # downs
    sites += [(4 * f, n // 16)] * 3 + [(2 * f, n // 4)] * 3 \
        + [(f, n)] * 3                                       # ups
    sites += [(f // 2, 4 * n)] * 3                           # final stage
    return [(c, px, False) for c, px in sites]


def b1_forward_bytes_per_slice(h: int, w: int, f: int = 32,
                               elem_bytes: int = 2) -> int:
    """Bytes B1's forward must move for one slice: x read once, y written
    once (and a residual read where a site has one)."""
    return sum(elem_bytes * c * px * (3 if res else 2)
               for c, px, res in unet_b1_sites(h, w, f))


def b1_backward_bytes_per_slice(h: int, w: int, f: int = 32,
                                elem_bytes: int = 2) -> int:
    """Bytes B1's backward must move for one slice: the saved input and
    the output gradient read once, the input gradient written once."""
    return sum(elem_bytes * c * px * 3
               for c, px, _ in unet_b1_sites(h, w, f))
