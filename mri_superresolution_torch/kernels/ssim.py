"""Fused per-image SSIM: kernel B2.

Replaces the TPU kernel ``experiments/ssim_pallas.py``
(``ssim_fused_per_sample``, and ``ssim_fused`` around it). The CUDA source
is ``csrc/ssim_fused.cu``; its note says what bounds it on the H100 and how
strips, bands and a register ring replace the TPU kernel's whole image in
VMEM. :func:`ssim_plan` gives its launch geometry. The plain version is
``ops.ssim.ssim(..., size_average=False)``. Where autograd needs it,
:func:`ssim_per_sample` runs as a ``torch.autograd.Function``: the kernel
forward and the plain version's autograd backward, as JAX's
``custom_vjp`` routes its backward through XLA. The loss takes a weighted
mean of its (B,) values; :func:`ssim_fused` is their plain mean.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.ops.ssim import _gaussian_window_np, ssim

MAX_WINDOW = 15
# csrc/ssim_fused.cu: threads a block (the input columns of a strip), rows
# a group, outputs a row-pass thread, widest strip, static shared bytes
THREADS = 160
ROWS = 8
OUT = 8
MAX_STRIP = (THREADS - MAX_WINDOW + 1) // OUT * OUT     # 144
SHARED_BYTES = 2 * 4 * ROWS * 164 * 4 + 8 * (THREADS // 32) + 1
# the plan's guess of co-resident blocks when the card is not asked, and
# its model's constants (ssim_plan)
DEFAULT_PER_SM, DEFAULT_SMS = 3, 132
MIN_BLOCKS_PER_SM, WAVE_ROWS = 2, 8


class SSIMPlan(NamedTuple):
    strip: int        # output columns a strip (multiple of OUT)
    strips: int
    rows: int         # output rows a band (multiple of ROWS)
    bands: int
    grid: tuple       # (strips, bands, B)
    threads: int
    shared_bytes: int


def ssim_plan(b: int, h: int, w: int, window_size: int,
              per_sm: int = DEFAULT_PER_SM,
              sms: int = DEFAULT_SMS) -> SSIMPlan:
    """Launch geometry of the kernel for (b, h, w) images. Strips: as few
    as widths of at most MAX_STRIP allow, of equal width rounded up to OUT.
    Bands: the height, a multiple of ROWS, that minimises a model of a
    SM's time fitted to the H100 (see PERF.md): its share of the blocks,
    n = ceil(blocks / sms), but at least MIN_BLOCKS_PER_SM (one block of
    five warps alone leaves the SM's issue slots idle), times a block's
    rows plus a tenth of a row for each halo row it loads again, plus
    WAVE_ROWS for each wave of ``per_sm`` co-resident blocks (a block's
    first loads and its last reduction)."""
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty batch ({b}, {h}, {w})")
    if b > 65535:
        raise ValueError("fused SSIM takes at most 65535 images a call")
    strips = -(-w // MAX_STRIP)
    strip = OUT * -(-(-(-w // strips)) // OUT)
    best = None
    for rows in range(ROWS, ROWS * -(-h // ROWS) + 1, ROWS):
        bands = -(-h // rows)
        if bands > 65535:
            continue
        n = -(-(b * strips * bands) // max(1, sms))
        waves = -(-n // max(1, per_sm))
        cost = max(n, MIN_BLOCKS_PER_SM) * (rows + 0.1 * (window_size - 1)) \
            + WAVE_ROWS * waves
        if best is None or cost < best[0]:
            best = (cost, rows, bands)
        if rows >= 512:
            break
    if best is None:
        raise ValueError(f"fused SSIM: no plan for height {h}")
    _, rows, bands = best
    return SSIMPlan(strip, strips, rows, bands, (strips, bands, b), THREADS,
                    SHARED_BYTES)


def pow2_scale(val_range: float) -> float:
    """The power of two nearest 1 / |val_range| (within 2^-48 .. 2^48; 1
    for 0 or a non-finite range): the kernel scales its maps by it, which
    is exact, so that the map's denominator stays near 1."""
    a = abs(val_range)
    if a == 0 or not math.isfinite(a):
        return 1.0
    return 2.0 ** max(-48, min(48, -round(math.log2(a))))


def ssim_per_sample_plain(img1: torch.Tensor, img2: torch.Tensor,
                          window_size: int = 11, sigma: float = 1.5,
                          val_range: float = 1.0) -> torch.Tensor:
    return ssim(img1[..., None], img2[..., None], window_size, sigma,
                val_range, size_average=False)


@functools.lru_cache(maxsize=None)
def _capacity(index: int, window_size: int) -> tuple:
    """(co-resident blocks a SM, SMs) of the kernel for ``window_size`` on
    CUDA device ``index``, asked once."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.library().msr_ssim_capacity(
            window_size, ctypes.byref(per_sm), ctypes.byref(sms))
    _build.check(code, "ssim_per_sample (capacity)")
    return per_sm.value, sms.value


def _single_channel(img1: torch.Tensor, img2: torch.Tensor) -> tuple:
    if img1.dim() == 4:
        if img1.shape[-1] != 1 or img2.shape[-1] != 1:
            raise ValueError("fused SSIM is single-channel")
        img1, img2 = img1[..., 0], img2[..., 0]
    if img1.dim() != 3 or img1.shape != img2.shape:
        raise ValueError(f"inputs must be matching (B, H, W), got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    return img1, img2


def ssim_per_sample(img1: torch.Tensor, img2: torch.Tensor,
                    window_size: int = 11, sigma: float = 1.5,
                    val_range: float = 1.0) -> torch.Tensor:
    """Per-image SSIM (B,) fp32 of single-channel batches, (B, H, W) or
    (B, H, W, 1). Inputs are cast to float32, as the JAX kernel casts them.
    The kernel takes contiguous inputs on the card; CPU tensors go to the
    plain version. Differentiable: see the module's note."""
    img1, img2 = _single_channel(img1, img2)
    if img1.device != img2.device:
        raise ValueError("inputs must share a device")
    if window_size % 2 == 0 or not 1 <= window_size <= MAX_WINDOW:
        raise ValueError(f"window_size must be odd and <= {MAX_WINDOW}")
    img1, img2 = img1.float(), img2.float()
    if _build.needs_grad(img1, img2):
        return _SSIMPerSample.apply(img1, img2, window_size, sigma,
                                    val_range)
    return _forward(img1, img2, window_size, sigma, val_range)


def _forward(img1, img2, window_size, sigma, val_range):
    if img1.device.type == "cpu":
        return ssim_per_sample_plain(img1, img2, window_size, sigma,
                                     val_range)
    if img1.device.type != "cuda":
        raise ValueError(f"unsupported device {img1.device}")
    if not (img1.is_contiguous() and img2.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    b, h, w = img1.shape
    if h * w >= 2 ** 31:
        raise ValueError("fused SSIM takes images of fewer than 2^31 pixels")
    dev = img1.device
    plan = ssim_plan(b, h, w, window_size,
                     *_capacity(_build.device_index(dev), window_size))
    win = _gaussian_window_np(window_size, sigma)
    partial = torch.empty((b, plan.strips * plan.bands), dtype=torch.float64,
                          device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    cnt = _build.counters(dev, b, "ssim_per_sample")
    s = pow2_scale(val_range)
    code = _build.library().msr_ssim_fwd(
        img1.data_ptr(), img2.data_ptr(), win.ctypes.data, partial.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), b, h, w, window_size, plan.strip,
        plan.strips, plan.rows, plan.bands, (0.01 * val_range * s) ** 2,
        (0.03 * val_range * s) ** 2, s, _build.stream_ptr(dev))
    ssim_per_sample.launches += 1
    _build.check(code, "ssim_per_sample")
    return out


ssim_per_sample.launches = 0


class _SSIMPerSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img1, img2, window_size, sigma, val_range):
        ctx.save_for_backward(img1, img2)
        ctx.args = (window_size, sigma, val_range)
        return _forward(img1, img2, window_size, sigma, val_range)

    @staticmethod
    def backward(ctx, grad):
        img1, img2 = ctx.saved_tensors
        with torch.enable_grad():
            a = img1.detach().requires_grad_()
            b = img2.detach().requires_grad_()
            d1, d2 = torch.autograd.grad(
                ssim_per_sample_plain(a, b, *ctx.args), (a, b), grad)
        return d1, d2, None, None, None


def ssim_fused(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
               sigma: float = 1.5, val_range: float = 1.0) -> torch.Tensor:
    """Scalar mean SSIM of single-channel batches, (B, H, W) or (B, H, W,
    1): the mean of :func:`ssim_per_sample`, differentiable
    (``ssim_pallas.ssim_fused``)."""
    return ssim_per_sample(img1, img2, window_size, sigma, val_range).mean()


def flops_per_pixel(window_size: int) -> int:
    """fp32 operations a pixel of the least work for this function (an FMA
    counts 2): the products x1^2 + x2^2 and x1 x2 (4), two passes of four
    maps over the window (16 window), the map (16)."""
    return 4 + 16 * window_size + 16

