"""B1's one-pass routes, host side: the wave plan and the layout checks
that decide which shapes the one-pass kernels take, forward
(``csrc/groupnorm_onepass.cu``) and backward
(``csrc/groupnorm_bwd_onepass.cu``). They are pure functions, so they run
here on the CPU; the kernels themselves are held against the plain
versions on the card (``tests/test_torch_cuda.py``). The forward's
arithmetic is B1's, held against the Pallas kernel and flax in
``tests/test_torch_kernels.py``; the backward's twin against the JAX
package's ``_backward`` in ``tests/test_torch_train.py``.
"""

import pytest
import torch

from mri_superresolution_torch.kernels.groupnorm import (
    _onepass_bwd_layout_ok, _onepass_layout_ok, _plan_onepass,
    onepass_backward_plan)

# An H100 SXM: one block an SM, each with the 227 KB a block may use less
# the kernel's 10,368-byte header (mbarrier, statistics, partials).
N_BLOCKS = 132
STAGE = 232448 - 10368
# The backward stages x and g: each gets half of what the 227 KB leave
# beside its 41,088-byte header, in whole 128-byte lines
# (msr_gn_onepass_bwd_capacity).
STAGE_BWD = (232448 - 41088) // 2 // 128 * 128


def _most_per_wave(hw, c, itemsize):
    need = -(-hw // (STAGE // (c * itemsize)))
    return N_BLOCKS // need


def _staged(plan, b, hw):
    """(wave, block, image, first pixel, end pixel) of every range the
    kernel stages, by the mapping OnePassPlan documents and
    csrc/groupnorm_onepass.cu implements."""
    for wave in range(plan.waves):
        for blk in range(plan.ranges * plan.images_per_wave):
            img = wave * plan.images_per_wave + blk // plan.ranges
            if img < b:
                p0 = (blk % plan.ranges) * plan.chunk_px
                yield wave, blk, img, p0, min(p0 + plan.chunk_px, hw)


# the unet's five GroupNorm shapes (base_filters 32, 256^2 in): (C, H * W)
@pytest.mark.parametrize("c,hw", [(32, 256 * 256), (64, 128 * 128),
                                  (128, 64 * 64), (256, 32 * 32),
                                  (16, 512 * 512)])
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_onepass_stages_each_image_once_in_one_wave(c, hw, b, itemsize):
    plan = _plan_onepass(b, hw, c, itemsize, N_BLOCKS, STAGE)
    assert plan is not None
    grid = plan.ranges * plan.images_per_wave
    assert grid <= N_BLOCKS
    # the fewest waves: no wave could hold more whole images
    assert plan.waves == -(-b // plan.images_per_wave)
    assert (plan.waves - 1) * _most_per_wave(hw, c, itemsize) < b
    ranges, waves = {}, {}
    seen = set()
    for wave, blk, img, p0, p1 in _staged(plan, b, hw):
        assert 0 <= blk < grid and (wave, blk) not in seen
        seen.add((wave, blk))
        assert 0 <= p0 < p1 <= hw
        nbytes = (p1 - p0) * c * itemsize
        assert nbytes <= STAGE                     # fits the block
        assert (p0 * c * itemsize) % 16 == 0 and nbytes % 16 == 0
        ranges.setdefault(img, []).append((p0, p1))
        waves.setdefault(img, set()).add(wave)
    assert sorted(ranges) == list(range(b))
    for img, rs in ranges.items():
        assert len(waves[img]) == 1                # all in one wave
        rs.sort()
        assert len(rs) == plan.ranges
        assert rs[0][0] == 0 and rs[-1][1] == hw   # tiles the image once
        assert all(a[1] == nxt[0] for a, nxt in zip(rs, rs[1:]))


@pytest.mark.parametrize("b,hw,c,itemsize", [
    (1, 1024 * 1024, 32, 2),       # 64 MiB: more than 132 blocks can stage
    (16, 1024 * 1024, 16, 4),
    (4, 8, 65536, 4),              # one pixel is larger than a block's stage
])
def test_plan_onepass_is_none_when_an_image_does_not_fit(b, hw, c, itemsize):
    assert _plan_onepass(b, hw, c, itemsize, N_BLOCKS, STAGE) is None


def test_plan_onepass_at_the_edge_of_the_chip():
    """An image that needs exactly every block fits, one pixel more does
    not."""
    c, itemsize = 16, 2
    max_px = STAGE // (c * itemsize)
    plan = _plan_onepass(3, N_BLOCKS * max_px, c, itemsize, N_BLOCKS, STAGE)
    assert plan == (max_px, N_BLOCKS, 1, 3)
    assert _plan_onepass(1, N_BLOCKS * max_px + 1, c, itemsize, N_BLOCKS,
                         STAGE) is None


@pytest.mark.parametrize("c,itemsize,groups,ok", [
    (16, 2, 8, True), (32, 2, 8, True), (64, 2, 8, True),
    (128, 2, 8, True), (256, 2, 8, True),           # the unet, bf16
    (16, 4, 8, True), (256, 4, 8, True),            # fp32
    (8, 2, 8, True),                                # one vector, 8 groups
    (24, 2, 8, False),                              # 3 vectors a pixel
    (12, 4, 4, False),
    (20, 2, 4, False),                              # not whole vectors
    (2048, 4, 8, True), (4096, 4, 8, False),        # 1024 vectors > 512
    (512, 2, 512, False),                           # too many groups
])
def test_onepass_layout_ok(c, itemsize, groups, ok):
    assert _onepass_layout_ok(c, itemsize, groups) is ok


# the unet's five GroupNorm shapes at the training batch (8 x 128^2 in,
# base_filters 32): (C, H * W), and the waves of each in bf16 and fp32
@pytest.mark.parametrize("c,hw,waves", [
    (32, 128 * 128, (1, 2)), (64, 64 * 64, (1, 1)), (128, 32 * 32, (1, 1)),
    (256, 16 * 16, (1, 1)), (16, 256 * 256, (2, 3))])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_backward_plan_at_the_training_sites(c, hw, waves, itemsize):
    """Every training site takes the one-pass backward, in bf16 and fp32:
    its layout is taken, and its images are staged whole, each exactly
    once, x's range and g's range each within the block's share."""
    b = 8
    assert _onepass_bwd_layout_ok(c, itemsize, 8)
    plan = _plan_onepass(b, hw, c, itemsize, N_BLOCKS, STAGE_BWD)
    assert plan is not None
    assert plan.waves == waves[itemsize // 4]
    assert plan.ranges * plan.images_per_wave <= N_BLOCKS
    staged = {}
    for wave, blk, img, p0, p1 in _staged(plan, b, hw):
        assert (p1 - p0) * c * itemsize <= STAGE_BWD
        assert (p0 * c * itemsize) % 16 == 0
        staged.setdefault(img, []).append((wave, p0, p1))
    assert sorted(staged) == list(range(b))
    for rs in staged.values():
        assert len({w for w, _, _ in rs}) == 1
        rs.sort()
        assert rs[0][1] == 0 and rs[-1][2] == hw
        assert all(a[2] == nxt[1] for a, nxt in zip(rs, rs[1:]))


@pytest.mark.parametrize("b,hw,c,itemsize", [
    (8, 512 * 512, 16, 4),         # 16 MiB of x and as much of g
    (1, 1024 * 1024, 32, 2),
    (2, 4, 32768, 4),              # one pixel beyond a block's share
])
def test_backward_plan_is_none_when_x_and_g_do_not_fit(b, hw, c, itemsize):
    assert _plan_onepass(b, hw, c, itemsize, N_BLOCKS, STAGE_BWD) is None


def test_backward_plan_at_the_edge_of_the_chip():
    """An image whose x needs exactly every block's share fits; one pixel
    more does not."""
    c, itemsize = 16, 2
    max_px = STAGE_BWD // (c * itemsize)
    assert _plan_onepass(2, N_BLOCKS * max_px, c, itemsize, N_BLOCKS,
                         STAGE_BWD) == (max_px, N_BLOCKS, 1, 2)
    assert _plan_onepass(1, N_BLOCKS * max_px + 1, c, itemsize, N_BLOCKS,
                         STAGE_BWD) is None


@pytest.mark.parametrize("c,itemsize,groups,ok", [
    (16, 2, 8, True), (32, 2, 8, True), (64, 2, 8, True),
    (128, 2, 8, True), (256, 2, 8, True),           # the unet, bf16
    (16, 4, 8, True), (256, 4, 8, True),            # fp32
    (8, 2, 8, True), (8, 4, 8, True),               # one channel a group
    (512, 2, 8, False), (512, 4, 8, False),         # more than 256 channels
    (24, 2, 8, False), (24, 4, 8, False),           # 3 and 6 vectors a pixel
    (20, 2, 4, False),                              # not whole vectors
    (256, 2, 256, False),                           # partials overflow
    (128, 2, 128, True),
])
def test_onepass_bwd_layout_ok(c, itemsize, groups, ok):
    assert _onepass_bwd_layout_ok(c, itemsize, groups) is ok


def _cl(shape, dtype, offset=0):
    b, c, h, w = shape
    buf = torch.zeros(b * c * h * w + offset, dtype=dtype)
    return buf[offset:].view(b, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("which", ["x", "g", "dx"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_route_refuses_misaligned_tensors(which, dtype):
    """A tensor that is not 16-byte aligned sends the call to the
    four-pass kernel; decided before the card is asked anything."""
    shape = (2, 32, 8, 8)
    t = {k: _cl(shape, dtype, 1 if k == which else 0)
         for k in ("x", "g", "dx")}
    assert t[which].data_ptr() % 16
    assert onepass_backward_plan(t["x"], t["g"], t["dx"]) is None


@pytest.mark.parametrize("c", [24, 512])
def test_backward_route_refuses_unsupported_layouts(c):
    x = _cl((1, c, 4, 4), torch.bfloat16)
    assert onepass_backward_plan(x, x, x) is None
