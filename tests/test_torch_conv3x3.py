"""Kernel B3's decomposition, pinned on the CPU.

The bf16 kernel (``csrc/conv3x3_mma.cu``) runs only on the card. These
tests hold the math it is built on: the weight repack into its (Co, 9, Ci)
layout, and the implicit GEMM it computes: a sum over 9 shifted views of
the zero-padded input times one tap's weights each, taken chunk by chunk
of ``k_chunk(ci)`` channels (zero-padded past Ci), then over dw, then dh,
as the kernel takes it. The kernel itself is held to ``conv3x3_plain`` on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels.conv3x3 import (conv3x3_plain,
                                                       k_chunk, pack_weight)

torch.set_num_threads(2)

# (b, ci, co, h, w): the CUDA tests' shapes, cut to CPU size
SHAPES = [
    (2, 32, 16, 27, 35),     # final_up_conv, ragged
    (1, 16, 16, 33, 70),     # final_conv1, ragged
    (1, 3, 8, 17, 9),        # Ci below one chunk: element loads
    (1, 40, 64, 20, 33),     # two chunks, the second ragged; widest Co
    (1, 24, 24, 9, 12),      # Ci % 16 != 0 inside one chunk
    (1, 16, 8, 8, 8),
]


def _inputs(b, ci, co, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, ci), np.float32))
    wt = torch.from_numpy(
        rng.standard_normal((co, ci, 3, 3), np.float32) / np.sqrt(9 * ci))
    return x.permute(0, 3, 1, 2), wt


def unpack_weight(packed: torch.Tensor) -> torch.Tensor:
    """(Co, 9, Ci) -> (Co, Ci, 3, 3): the inverse of pack_weight."""
    co, _, ci = packed.shape
    return packed.view(co, 3, 3, ci).permute(0, 3, 1, 2)


def tap_gemm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's sum in its own K order, in fp32: for each chunk of
    k_chunk(Ci) channels (zero-padded past Ci), for each dw, for each dh,
    the (pixels x chunk) view of the padded input shifted by (dh, dw) times
    that tap's (chunk x Co) weights."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    kc = k_chunk(ci)
    cpad = -(-ci // kc) * kc
    wp = F.pad(pack_weight(weight).float(), (0, cpad - ci))   # (Co, 9, cpad)
    xh = F.pad(x.float().permute(0, 2, 3, 1), (0, cpad - ci, 1, 1, 1, 1))
    acc = torch.zeros(b * h * w, co)
    for c0 in range(0, cpad, kc):
        for dw in range(3):
            for dh in range(3):
                a = xh[:, dh:dh + h, dw:dw + w, c0:c0 + kc].reshape(-1, kc)
                acc += a @ wp[:, 3 * dh + dw, c0:c0 + kc].T
    return acc.view(b, h, w, co).permute(0, 3, 1, 2)


@pytest.mark.parametrize("co,ci", [(16, 32), (16, 16), (8, 3), (64, 40),
                                   (24, 24)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_pack_weight_round_trips(co, ci, channels_last):
    _, wt = _inputs(1, ci, co, 1, 1, seed=co + ci)
    if channels_last:
        wt = wt.contiguous(memory_format=torch.channels_last)
    p = pack_weight(wt)
    assert p.shape == (co, 9, ci) and p.is_contiguous()
    assert torch.equal(unpack_weight(p), wt)
    for dh in range(3):
        for dw in range(3):
            assert torch.equal(p[:, 3 * dh + dw, :], wt[:, :, dh, dw])


def test_pack_weight_is_a_view_of_a_channels_last_weight():
    """The unet casts its narrow weights to channels_last, so the wrapper's
    repack adds no copy (and no launch) per call."""
    _, wt = _inputs(1, 32, 16, 1, 1)
    wt = wt.to(torch.bfloat16, memory_format=torch.channels_last)
    assert pack_weight(wt).data_ptr() == wt.data_ptr()


@pytest.mark.parametrize("ci,want", [(1, 16), (3, 16), (16, 16), (17, 32),
                                     (32, 32), (40, 32)])
def test_k_chunk(ci, want):
    assert k_chunk(ci) == want


@pytest.mark.parametrize("b,ci,co,h,w", SHAPES)
def test_tap_gemm_matches_plain_fp32(b, ci, co, h, w):
    x, wt = _inputs(b, ci, co, h, w)
    got = tap_gemm(x, wt)
    # the same sum in another order: fp32 rounding only
    torch.testing.assert_close(got, conv3x3_plain(x, wt), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,ci,co,h,w", SHAPES)
def test_tap_gemm_matches_plain_bf16(b, ci, co, h, w):
    x, wt = _inputs(b, ci, co, h, w, seed=1)
    x, wt = x.bfloat16(), wt.bfloat16()
    got = tap_gemm(x, wt).bfloat16()
    want = conv3x3_plain(x, wt)
    # bf16 products are exact in fp32; the sums differ in order only, so
    # the results differ by at most one bf16 rounding
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-5)
