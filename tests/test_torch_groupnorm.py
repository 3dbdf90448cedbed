"""B1's one-pass route, host side: the wave plan and the layout check that
decide which shapes the one-pass kernel (``csrc/groupnorm_onepass.cu``)
takes. Both are pure functions, so they run here on the CPU; the kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``). The kernel's arithmetic is B1's, held
against the Pallas kernel and flax in ``tests/test_torch_kernels.py``.
"""

import pytest

from mri_superresolution_torch.kernels.groupnorm import (_onepass_layout_ok,
                                                         _plan_onepass)

# An H100 SXM: one block an SM, each with the 227 KB a block may use less
# the kernel's 10,368-byte header (mbarrier, statistics, partials).
N_BLOCKS = 132
STAGE = 232448 - 10368


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
