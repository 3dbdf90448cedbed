"""Kernel B2 (fused per-image SSIM) on the CPU: the launch plan of
``csrc/ssim_fused.cu``, a numpy model of the kernel's order of work and
sums against the plain version and the JAX package's Pallas kernel (in
interpret mode), the float32 cast of other input types, and
``ssim_fused``'s value and gradients against ``jax.grad`` of JAX's
``ssim_fused``.

The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.experiments.ssim_pallas import (
    ssim_fused as jax_ssim_fused, ssim_fused_per_sample)
from mri_superresolution_torch import kernels
from mri_superresolution_torch.kernels.ssim import (
    MAX_STRIP, OUT, ROWS, THREADS, pow2_scale, ssim_fused, ssim_per_sample,
    ssim_per_sample_plain, ssim_plan)
from mri_superresolution_torch.ops.ssim import _gaussian_window_np

torch.set_num_threads(2)

# the kernel against the plain version: fp32 throughout, sums in another
# order, the two sigmas blurred as one map; the CUDA tests' gate
ATOL = 1e-5
SMEM_MAX = 232448          # a block's shared memory on the H100


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def _tree(vals):
    """A warp's __shfl_down_sync sum tree over 32 lanes: lane 0's result."""
    v = list(vals)
    for off in (16, 8, 4, 2, 1):
        v = [v[i] + v[i + off] if i + off < 32 else v[i] for i in range(32)]
    return v[0]


def _block(a, b, g, plan, strip, band, c1, c2, scale):
    """One block of the kernel: its partial (float64)."""
    h_img, w_img = a.shape
    ws = len(g)
    halo = ws // 2
    x0, y0 = strip * plan.strip, band * plan.rows
    cols = x0 - halo + np.arange(THREADS)
    col_in = (cols >= 0) & (cols < w_img)

    def maps(y):
        # the four maps of input row y for the block's THREADS columns
        if not 0 <= y < h_img:
            return np.zeros((4, THREADS), np.float32)
        x1 = np.where(col_in, a[y, np.clip(cols, 0, w_img - 1)], 0)
        x2 = np.where(col_in, b[y, np.clip(cols, 0, w_img - 1)], 0)
        x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
        return np.stack([x1, x2, x2 * x2 + x1 * x1, x1 * x2])

    ring = np.stack([maps(y0 - halo + i) for i in range(ws - 1)], axis=1) \
        if ws > 1 else np.zeros((4, 0, THREADS), np.float32)
    nch = plan.strip // OUT
    sums = np.zeros((ROWS, nch), np.float32)    # row-pass task (r, ch)
    for gi in range(plan.rows // ROWS):
        yg = y0 + gi * ROWS
        new = np.stack([maps(yg + halo + j) for j in range(ROWS)], axis=1)
        rows_in = np.concatenate([ring, new], axis=1)   # (4, ws + 7, T)
        # the column pass's taps carry the power-of-two scale: s for x1
        # and x2, s^2 for the products
        gs = np.stack([g * scale, g * scale, g * scale ** 2,
                       g * scale ** 2]).astype(np.float32)[:, :, None, None]
        vert = gs[:, 0] * rows_in[:, 0:ROWS]
        for k in range(1, ws):
            vert = gs[:, k] * rows_in[:, k:k + ROWS] + vert
        ring = rows_in[:, ROWS:ROWS + ws - 1]
        hor = g[0] * vert[:, :, 0:plan.strip]
        for k in range(1, ws):
            hor = g[k] * vert[:, :, k:k + plan.strip] + hor
        m1, m2, q, p = hor
        mu1_sq, mu2_sq, mu12 = m1 * m1, m2 * m2, m1 * m2
        smap = ((2 * mu12 + c1) * (2 * (p - mu12) + c2)) / (
            (mu1_sq + mu2_sq + c1) * (((q - mu1_sq) - mu2_sq) + c2))
        ok = (yg + np.arange(ROWS) < h_img)[:, None] & \
            (x0 + np.arange(plan.strip) < w_img)[None, :]
        smap = np.where(ok, smap, np.float32(0)).reshape(ROWS, nch, OUT)
        for o in range(OUT):
            sums = sums + smap[:, :, o]
    # thread t runs task (t % ROWS, t // ROWS); the rest sum nothing
    per_thread = np.zeros(THREADS, np.float64)
    per_thread[:ROWS * nch] = sums.T.reshape(-1)
    warps = [_tree(per_thread[w:w + 32]) for w in range(0, THREADS, 32)]
    total = 0.0
    for s in warps:
        total += s
    return total


def kernel_model(a, b, window_size=11, sigma=1.5, val_range=1.0, plan=None,
                 scale=None):
    """(B,) float32 by the kernel's structure and order of sums: strips of
    ``plan.strip`` output columns with the halo on each side (zeros outside
    the image); bands of ``plan.rows`` rows walked 8 at a time, the last
    window - 1 input rows of the four maps (x1, x2, x1^2 + x2^2, x1 x2)
    carried in a ring; the column blur (its taps times the power of two
    nearest 1 / val_range, which scales every map exactly, with c1 and c2
    scaled to match), then the row blur of 8 outputs a
    thread; fp32 sums a thread, a block's partial in float64 (warp trees,
    then the warps in order); each image's partials in block index order
    summed by 32 lanes, each every 32nd, then a warp tree."""
    bsz, h, w = a.shape
    plan = plan or ssim_plan(bsz, h, w, window_size)
    g = _gaussian_window_np(window_size, sigma)
    s = pow2_scale(val_range) if scale is None else scale
    c1 = np.float32((0.01 * val_range * s) ** 2)
    c2 = np.float32((0.03 * val_range * s) ** 2)
    out = np.empty(bsz, np.float32)
    for i in range(bsz):
        parts = [_block(a[i], b[i], g, plan, st, band, c1, c2, s)
                 for band in range(plan.bands) for st in range(plan.strips)]
        lanes = [0.0] * 32
        for j, p in enumerate(parts):
            lanes[j % 32] += p
        out[i] = np.float32(_tree(lanes) / (float(h) * w))
    return out


# --------------------------------------------------------------- the plan

PLAN_CASES = [(1, 1, 1, 11), (2, 17, 600, 15), (1, 512, 512, 11),
              (8, 512, 512, 11), (16, 512, 512, 11), (3, 5, 37, 7),
              (1, 1000, 129, 3), (4, 64, 128, 1), (2, 300, 257, 13)]


@pytest.mark.parametrize("b,h,w,ws", PLAN_CASES)
@pytest.mark.parametrize("per_sm", [1, 3, 1000])
def test_ssim_plan_owns_every_output_once(b, h, w, ws, per_sm):
    """Every output pixel of an image is owned by exactly one (strip,
    band, group, row-pass task, output); strips and bands are cut at the
    ragged edge, none is empty."""
    plan = ssim_plan(b, h, w, ws, per_sm=per_sm)
    assert plan.grid == (plan.strips, plan.bands, b)
    col = np.zeros(w, np.int64)
    for s in range(plan.strips):
        for ch in range(plan.strip // OUT):
            for o in range(OUT):
                x = s * plan.strip + ch * OUT + o
                if x < w:
                    col[x] += 1
    row = np.zeros(h, np.int64)
    for band in range(plan.bands):
        for gi in range(plan.rows // ROWS):
            for r in range(ROWS):
                y = band * plan.rows + gi * ROWS + r
                if y < h:
                    row[y] += 1
    np.testing.assert_array_equal(np.outer(row, col), np.ones((h, w)))
    assert (plan.strips - 1) * plan.strip < w <= plan.strips * plan.strip
    assert (plan.bands - 1) * plan.rows < h <= plan.bands * plan.rows


@pytest.mark.parametrize("b,h,w,ws", PLAN_CASES)
def test_ssim_plan_fits_the_block(b, h, w, ws):
    """The strip and its halo fit the block's threads (one input column
    each), the row pass's tasks fit too, and the shared memory fits."""
    plan = ssim_plan(b, h, w, ws)
    assert plan.strip % OUT == 0 and OUT <= plan.strip <= MAX_STRIP
    assert plan.strip + ws - 1 <= plan.threads == THREADS
    assert ROWS * (plan.strip // OUT) <= THREADS
    assert plan.rows % ROWS == 0
    assert plan.shared_bytes <= SMEM_MAX
    assert plan.bands <= 65535 and plan.grid[2] <= 65535


def test_ssim_plan_spreads_blocks_over_the_sms():
    """One image fills the card with the thinnest bands; a batch takes
    thicker bands, in one wave of blocks that still gives every SM one."""
    assert ssim_plan(1, 512, 512, 11).rows == ROWS
    for b in (8, 16):
        p = ssim_plan(b, 512, 512, 11, per_sm=3, sms=132)
        assert (p.strip, p.strips) == (128, 4)
        blocks = b * p.strips * p.bands
        assert p.rows > ROWS and 132 < blocks <= 3 * 132
    with pytest.raises(ValueError):
        ssim_plan(0, 8, 8, 11)


# ------------------------------------------------- the model of the kernel

@pytest.mark.parametrize("window", [7, 11, 15])
@pytest.mark.parametrize("shape,per_sm", [
    ((2, 20, 150), 1000),     # two strips, W not a multiple of the strip
    ((1, 5, 37), 1000),       # H < window
    ((2, 35, 40), 1000),      # bands of 8, a ragged last band
    ((1, 35, 40), 1),         # one band of 40 rows
])
def test_kernel_model_matches_plain_and_pallas(window, shape, per_sm):
    a, b = _pair(shape, 11 + window)
    plan = ssim_plan(*shape, window, per_sm=per_sm)
    got = kernel_model(a, b, window, plan=plan)
    plain = ssim_per_sample_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  window_size=window).numpy()
    pallas = np.asarray(ssim_fused_per_sample(
        jnp.asarray(a), jnp.asarray(b), window_size=window, interpret=True))
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_kernel_model_other_sigma_and_range():
    a, b = _pair((1, 24, 30), 5)
    a, b = 255 * a, 255 * b
    got = kernel_model(a, b, 9, sigma=2.0, val_range=255.0,
                       plan=ssim_plan(1, 24, 30, 9, per_sm=1000))
    want = ssim_per_sample_plain(torch.from_numpy(a), torch.from_numpy(b),
                                 window_size=9, sigma=2.0,
                                 val_range=255.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ------------------------------------------------------- input types

@pytest.mark.parametrize("shape", [(2, 24, 20), (1, 16, 16, 1)])
def test_ssim_per_sample_casts_bf16_like_jax(shape):
    """bf16 inputs are cast to float32, as ssim_fused_per_sample casts
    them: the same rounded inputs, the same result within the gate."""
    a, b = _pair(shape, 7)
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    got = ssim_per_sample(ta, tb)
    assert got.dtype == torch.float32
    want = np.asarray(ssim_fused_per_sample(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        ssim_per_sample(ta.double(), tb.double()).numpy(), got.numpy())


# ------------------------------------------------------- ssim_fused

@pytest.mark.parametrize("shape", [(2, 24, 20), (3, 16, 18, 1)])
def test_ssim_fused_value_and_grads_match_jax(shape):
    """Value and both gradients against jax.grad of JAX's ssim_fused (Pallas
    forward in interpret mode, XLA backward): rtol 1e-4, atol 1e-6, the
    difference of two fp32 autograd paths over the same formula."""
    a, b = _pair(shape, 9)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    kernels.reset_launch_counts()
    val = ssim_fused(ta, tb)
    val.backward()
    assert kernels.launch_counts()["ssim_per_sample"] == 0   # CPU: plain

    def f(x, y):
        return jax_ssim_fused(x, y, 11, 1.5, 1.0, True)

    want = f(jnp.asarray(a), jnp.asarray(b))
    d1, d2 = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(val.item(), float(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(d1), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(d2), rtol=1e-4,
                               atol=1e-6)


def test_ssim_fused_grad_of_one_input():
    """Only the input that needs a gradient gets one; the value is the
    mean of ssim_per_sample."""
    a, b = _pair((2, 12, 14), 13)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b)
    val = ssim_fused(ta, tb, window_size=7)
    assert val.item() == float(ssim_per_sample(ta.detach(), tb,
                                               window_size=7).mean())
    val.backward()
    assert ta.grad is not None and ta.grad.shape == ta.shape
    assert tb.grad is None


def test_sass_loops_counts_shared_loads_and_ffma():
    """tools/sass_loops counts shared loads (every width) and FFMAs per
    loop, the check of B2's loads per FMA on the card's SASS."""
    from mri_superresolution_torch.tools.sass_loops import parse, summarize
    sass = """
        Function : _Z16ssim_band_kernelILi11EEv
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   LDS.128 R8, [R3] ;
        /*0030*/                   FFMA R1, R8, c[0x0][0x210], R1 ;
        /*0040*/                   FFMA R1, R9, c[0x0][0x214], R1 ;
        /*0050*/                   LDS R10, [R3+0x10] ;
        /*0060*/                   FFMA R1, R10, c[0x0][0x218], R1 ;
        /*0070*/                   FFMA R1, R11, c[0x0][0x21c], R1 ;
        /*0080*/                   STS [R6], R1 ;
        /*0090*/              @P0 BRA 0x20 ;
        /*00a0*/                   EXIT ;
"""
    got = summarize(parse(sass)["_Z16ssim_band_kernelILi11EEv"])
    loop = got["loops"][0]
    assert (loop["from"], loop["to"]) == ("0x20", "0x90")
    assert loop["counts"] == {"LDS": 2, "STS": 1, "LDG": 0, "FFMA": 4,
                              "FMUL": 0, "FADD": 0, "lds_per_ffma": 0.5}
    assert got["main_path_counts"]["LDG"] == 1


@pytest.mark.parametrize("val_range,want", [(1.0, 1.0), (255.0, 2.0 ** -8),
                                            (0.003, 2.0 ** 8), (0.0, 1.0),
                                            (float("inf"), 1.0),
                                            (2.0 ** 80, 2.0 ** -48)])
def test_pow2_scale(val_range, want):
    assert pow2_scale(val_range) == want


def test_kernel_model_scale_is_exact():
    """Scaling the maps by a power of two leaves the map's bits as they
    were: the model at val_range 255 equals itself with the scale forced
    to 1, exactly, where the map is divided the same way."""
    a, b = _pair((1, 20, 24), 21)
    a, b = 255 * a, 255 * b
    plan = ssim_plan(1, 20, 24, 11, per_sm=1000)
    got = kernel_model(a, b, 11, val_range=255.0, plan=plan)
    assert pow2_scale(255.0) != 1.0
    want = kernel_model(a, b, 11, val_range=255.0, plan=plan, scale=1.0)
    np.testing.assert_array_equal(got, want)
