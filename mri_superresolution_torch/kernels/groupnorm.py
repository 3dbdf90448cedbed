"""Fused GroupNorm + LeakyReLU (+ residual): kernel B1.

Replaces the TPU kernel ``experiments/groupnorm_pallas.py``
(``fused_group_norm_leaky``, forward ``_pallas_forward``). On a CUDA tensor
two kernels serve it, chosen by shape:

- ``csrc/groupnorm_onepass.cu``, the one-pass route: whole images staged in
  the SMs' shared memory, wave by wave (:func:`_plan_onepass`), so x is read
  from HBM once. It takes x when x, y and the residual are 16-byte aligned,
  the channels split into 16-byte vectors in a power-of-two count, and one
  image fits on chip (:func:`_onepass_layout_ok`, :func:`_plan_onepass`).
- ``csrc/groupnorm_leaky.cu``, the two-pass route, for every other shape
  (an offset view, an odd channel count, an image larger than the card's
  shared memory): a stats pass, then an apply pass, so x is read twice.

A failed launch of either raises; neither is chosen by catching an error.
The notes in both sources say what bounds them on the H100 (bytes). The
plain version below is the reference formula: fp32 statistics (mean, then
E[x^2] - mean^2), fp32 affine, LeakyReLU and residual in fp32, one cast
back to x's dtype.

Where autograd needs it (grad mode on and an input that requires grad),
:func:`group_norm_leaky` runs as a ``torch.autograd.Function``: the same
forward, and a backward by :func:`group_norm_leaky_backward`, B1's
gradient, in place of the JAX package's ``custom_vjp`` with its jnp
``_backward``. The residual's gradient is the output's. Otherwise
(serving, ``torch.no_grad``) the wrapper calls the kernel directly and
saves nothing. The gradient, like the forward, has two kernels chosen by
shape, and the plain twin :func:`group_norm_leaky_backward_plain` on a CPU
tensor:

- ``csrc/groupnorm_bwd_onepass.cu``, the one-pass route: one launch that
  stages each image's x and g on chip, in waves planned by
  :func:`_plan_onepass`, so both are read from HBM once. It takes x where
  x, g and dx are 16-byte aligned, at most 256 channels split into 16-byte
  vectors in a power-of-two count, and one image's x and g fit on chip
  (:func:`_onepass_bwd_layout_ok`, :func:`onepass_backward_plan`).
- ``csrc/groupnorm_bwd.cu``, the four-pass route, for every other shape.

:func:`gn_quantize` is kernel B4's fused route: the one-pass kernel with an
int8 output (bf16 x, no residual), which applies B4's LeakyReLU and
quantize to each element before it is stored, in place of B1 at slope 1.0
followed by ``kernels.leaky_quantize``. Where the one-pass route does not
take the shape, it runs those two kernels in turn.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build, _ops
from mri_superresolution_torch.kernels.leaky_quantize import (
    _check as _check_quantize, _empty_codes, leaky_quantize,
    leaky_quantize_plain)
from mri_superresolution_torch.ops.functional import GN_EPS, group_norm_fp32

# Elements each block of the two-pass kernel streams (its pixel chunk):
# enough work per block to hide the block's set-up, and many blocks per
# image so that batch-1 serving still fills the card.
_CHUNK_ELEMS = 16384
_DTYPES = (torch.float32, torch.bfloat16)
# the one-pass kernel's threads a block, largest group count and float2
# partial entries, as in csrc/groupnorm_onepass.cu
_ONEPASS_THREADS = 512
_ONEPASS_MAX_GROUPS = 256
_ONEPASS_PART_ENTRIES = 1024
# the one-pass backward's largest channel count and bytes of partials, as
# in csrc/groupnorm_bwd_onepass.cu
_BWD_MAX_CHANNELS = 256
_BWD_PART_BYTES = 32768


def group_norm_leaky_plain(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor,
                           residual: Optional[torch.Tensor] = None,
                           n_groups: int = 8, negative_slope: float = 0.2,
                           eps: float = GN_EPS) -> torch.Tensor:
    y = F.leaky_relu(group_norm_fp32(x, scale, bias, n_groups, eps),
                     negative_slope)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _check(x, scale, bias, residual, n_groups):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[1]
    if c % n_groups:
        raise ValueError(f"{c} channels do not split into {n_groups} groups")
    if not _build.channels_last(x):
        raise ValueError("x must be channels_last contiguous (make the layout "
                         "right at the call site)")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or not _build.channels_last(residual)):
        raise ValueError("residual must match x in shape, dtype, device and "
                         "channels_last layout")


def _launch_geometry(hw: int, c: int, itemsize: int, aligned: bool):
    """(vec, rows, chunk_px, nchunks) of a two-pass launch: vec elements per
    load, a power-of-two `rows` of pixels walked together by vpp * rows
    threads."""
    vec = 16 // itemsize
    if c % vec or not aligned:
        vec = 1
    vpp = c // vec
    rows = 1
    while vpp * rows * 2 <= max(vpp, 256):
        rows *= 2
    if vpp * rows > 1024:
        raise ValueError(f"{c} channels exceed the kernel's 1024 threads")
    if 2 * 4 * c * rows > 48 * 1024:
        raise ValueError(f"{c} channels exceed the kernel's shared memory")
    chunk_px = max(1, _CHUNK_ELEMS // c)
    nchunks = -(-hw // chunk_px)
    return vec, rows, chunk_px, nchunks


class OnePassPlan(NamedTuple):
    """Waves of the one-pass kernel. Its grid is ``ranges *
    images_per_wave`` blocks; in wave w, block j stages pixels ``[r *
    chunk_px, min((r + 1) * chunk_px, H * W))`` with ``r = j % ranges`` of
    image ``w * images_per_wave + j // ranges``, and stops at the first
    wave with no image for it."""
    chunk_px: int
    ranges: int
    images_per_wave: int
    waves: int


def _plan_onepass(b: int, hw: int, c: int, itemsize: int, n_blocks: int,
                  smem_bytes: int) -> Optional[OnePassPlan]:
    """The one-pass kernel's waves for ``b`` images of ``hw`` pixels of
    ``c`` channels, with ``n_blocks`` co-resident blocks that can each stage
    ``smem_bytes``; None when one image does not fit on chip.

    The fewest waves of whole images, the images spread evenly over them
    (``ceil(b / waves)`` a wave, the last wave the rest), and each image
    spread over all the blocks of its share of the grid, so that every
    block stages about the same bytes. Ranges are whole 16-byte units."""
    px_bytes = c * itemsize
    align_px = 16 // math.gcd(px_bytes, 16)
    max_px = smem_bytes // px_bytes // align_px * align_px
    if b < 1 or hw < 1 or max_px < 1:
        return None
    need = -(-hw // max_px)                      # blocks one image needs
    if need > n_blocks:
        return None
    per_wave = min(b, n_blocks // need)
    waves = -(-b // per_wave)
    per_wave = -(-b // waves)
    share = n_blocks // per_wave
    chunk = -(-hw // share)
    chunk = -(-chunk // align_px) * align_px
    return OnePassPlan(chunk, -(-hw // chunk), per_wave, waves)


def _onepass_layout_ok(c: int, itemsize: int, n_groups: int) -> bool:
    """Whether the one-pass kernel's thread layout takes ``c`` channels in
    ``n_groups`` groups: 16-byte vectors of V channels, a power-of-two count
    of them a pixel, each vector within one group or a whole number of
    groups, and the block's partials within its shared memory (as
    ``msr_gn_onepass_fwd`` checks)."""
    vec = 16 // itemsize
    if c % vec or n_groups > _ONEPASS_MAX_GROUPS:
        return False
    vpp, cg = c // vec, c // n_groups
    if vpp & (vpp - 1) or vpp > _ONEPASS_THREADS or (cg % vec and vec % cg):
        return False
    ent = vpp if cg >= vec else c
    prow = _ONEPASS_THREADS // max(vpp, 32)
    return prow * ent <= _ONEPASS_PART_ENTRIES


@functools.lru_cache(maxsize=None)
def _capacity(index: int) -> tuple:
    """(co-resident blocks, bytes each can stage) of the one-pass kernel
    on CUDA device ``index``, asked once per device."""
    n, stage = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.library().msr_gn_onepass_capacity(
            ctypes.byref(n), ctypes.byref(stage))
    _build.check(code, "group_norm_leaky (one-pass capacity)")
    return n.value, stage.value


def onepass_plan(x: torch.Tensor, y: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 n_groups: int = 8) -> Optional[OnePassPlan]:
    """The one-pass route's plan for a CUDA ``x`` (written to ``y``, of x's
    dtype or int8 codes), or None where the shape takes the two-pass
    route. x and the residual must be 16-byte aligned, and y aligned to
    one vector of its own type (16 bytes, or 8 for int8 codes)."""
    b, c, h, w = x.shape
    ptrs = [x.data_ptr()]
    if residual is not None:
        ptrs.append(residual.data_ptr())
    y_align = 16 * y.element_size() // x.element_size()
    if any(p % 16 for p in ptrs) or y.data_ptr() % y_align or \
            not _onepass_layout_ok(c, x.element_size(), n_groups):
        return None
    n_blocks, stage = _capacity(_build.device_index(x.device))
    return _plan_onepass(b, h * w, c, x.element_size(), n_blocks, stage)


def _onepass(x, scale, bias, residual, y, plan, n_groups, negative_slope,
             eps, qscale=None):
    """One launch of the one-pass kernel; with ``qscale`` (the int8
    scales) y takes int8 codes and the launch counts as ``gn_quantize``'s."""
    b, c, h, w = x.shape
    cnt = _build.counters(x.device, 2 * b, "group_norm_leaky")
    ws = torch.empty((b, plan.ranges, n_groups, 2), dtype=torch.float32,
                     device=x.device)
    code = _build.library().msr_gn_onepass_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        scale.data_ptr(), bias.data_ptr(),
        None if qscale is None else qscale.data_ptr(), y.data_ptr(),
        ws.data_ptr(), cnt.data_ptr(), b, h * w, c, n_groups, plan.chunk_px,
        plan.ranges, plan.images_per_wave, plan.waves,
        _capacity(_build.device_index(x.device))[1],
        int(x.dtype == torch.bfloat16), eps, negative_slope,
        _build.stream_ptr(x.device))
    if qscale is None:
        group_norm_leaky.launches += 1
        group_norm_leaky.onepass_launches += 1
        _build.check(code, "group_norm_leaky (one-pass)")
    else:
        gn_quantize.launches += 1
        _build.check(code, "gn_quantize (one-pass)")
    return y


def _twopass(x, scale, bias, residual, y, n_groups, negative_slope, eps):
    b, c, h, w = x.shape
    ptrs = [x.data_ptr(), y.data_ptr()]
    if residual is not None:
        ptrs.append(residual.data_ptr())
    vec, rows, chunk_px, nchunks = _launch_geometry(
        h * w, c, x.element_size(), all(p % 16 == 0 for p in ptrs))
    ws = torch.empty((b, nchunks, n_groups, 2), dtype=torch.float32,
                     device=x.device)
    code = _build.library().msr_gn_leaky_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(),
        b, h * w, c, n_groups, chunk_px, nchunks, rows, vec,
        int(x.dtype == torch.bfloat16), eps, negative_slope,
        _build.stream_ptr(x.device))
    group_norm_leaky.launches += 1
    _build.check(code, "group_norm_leaky (two-pass)")
    return y


def group_norm_leaky_twopass(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor,
                             residual: Optional[torch.Tensor] = None,
                             n_groups: int = 8, negative_slope: float = 0.2,
                             eps: float = GN_EPS) -> torch.Tensor:
    """The two-pass kernel on a CUDA ``x`` whatever its shape: what
    :func:`group_norm_leaky` runs where the one-pass route does not apply,
    callable alone so that the two routes can be compared."""
    _check(x, scale, bias, residual, n_groups)
    if x.device.type != "cuda":
        raise ValueError(f"the two-pass kernel needs a CUDA tensor, got "
                         f"{x.device}")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    return _twopass(x, scale, bias, residual, y, n_groups, negative_slope,
                    eps)


def _forward(x, scale, bias, residual, n_groups, negative_slope, eps):
    if x.device.type == "cpu":
        return group_norm_leaky_plain(x, scale, bias, residual, n_groups,
                                      negative_slope, eps).contiguous(
            memory_format=torch.channels_last)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = onepass_plan(x, y, residual, n_groups)
    if plan is not None:
        return _onepass(x, scale, bias, residual, y, plan, n_groups,
                        negative_slope, eps)
    return _twopass(x, scale, bias, residual, y, n_groups, negative_slope,
                    eps)


class _GroupNormLeaky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, residual, n_groups, negative_slope,
                eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (n_groups, negative_slope, eps)
        ctx.has_residual = residual is not None
        return _forward(x, scale, bias, residual, n_groups, negative_slope,
                        eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        g = g.contiguous(memory_format=torch.channels_last)
        dx, dscale, dbias = group_norm_leaky_backward(x, scale, bias, g,
                                                      *ctx.args)
        return (dx, dscale, dbias, g if ctx.has_residual else None, None,
                None, None)


def _op_forward(x, scale, bias, residual, n_groups, negative_slope, eps):
    _check(x, scale, bias, residual, n_groups)
    return _forward(x, scale, bias, residual, n_groups, negative_slope, eps)


def _fake_forward(x, scale, bias, residual, n_groups, negative_slope, eps):
    _check(x, scale, bias, residual, n_groups)
    return torch.empty_like(x, memory_format=torch.channels_last)


_GN_OP = _ops.register(
    "group_norm_leaky(Tensor x, Tensor scale, Tensor bias, "
    "Tensor? residual, int n_groups, float negative_slope, float eps) "
    "-> Tensor", _op_forward, _fake_forward)


def group_norm_leaky(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     n_groups: int = 8, negative_slope: float = 0.2,
                     eps: float = GN_EPS) -> torch.Tensor:
    """``leaky_relu(group_norm(x) * scale + bias) [+ residual]``.

    x: (B, C, H, W) float32 or bfloat16 in channels_last memory; scale,
    bias: (C,) float32; residual: like x. Returns x's dtype and layout.
    On a CUDA tensor the one-pass kernel where :func:`onepass_plan` gives a
    plan, else the two-pass kernel; the plain version on a CPU tensor.
    Differentiable: see the module's note. Without a gradient to keep, it
    is the operator ``torch.ops.mri_sr.group_norm_leaky`` to
    ``torch.export`` (``kernels/_ops.py``).
    """
    if _build.needs_grad(x, scale, bias, residual):
        _check(x, scale, bias, residual, n_groups)
        return _GroupNormLeaky.apply(x, scale, bias, residual, n_groups,
                                     negative_slope, eps)
    return _ops.call(_GN_OP, _op_forward, x, scale, bias, residual,
                     n_groups, negative_slope, eps)


group_norm_leaky.launches = 0
group_norm_leaky.onepass_launches = 0


def group_norm_leaky_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                                    bias: torch.Tensor, g: torch.Tensor,
                                    n_groups: int = 8,
                                    negative_slope: float = 0.2,
                                    eps: float = GN_EPS) -> tuple:
    """The JAX package's ``_backward`` (``experiments/groupnorm_pallas.py``
    :273-295) line by line, on NCHW-indexed tensors: (dx in x's dtype and
    layout, dscale, dbias in fp32). Two choices fix the bits of mean, rstd
    and z, and so the LeakyReLU mask, to the kernel's: the statistics are
    summed in float64 and rounded once to fp32, and rstd is ``1 / sqrt``,
    both IEEE-rounded (``rsqrt`` is approximate on the card)."""
    b, c, h, w = x.shape
    cg = c // n_groups
    shape = (b, n_groups, cg, h, w)
    xd = x.double().reshape(shape)
    mean = xd.mean(dim=(2, 3, 4), keepdim=True).float()
    var = (xd * xd).mean(dim=(2, 3, 4), keepdim=True).float() - mean * mean
    rstd = torch.sqrt(var + eps).reciprocal()
    xhat = (x.float().reshape(shape) - mean) * rstd
    sc = scale.float().reshape(1, n_groups, cg, 1, 1)
    z = xhat * sc + bias.float().reshape(1, n_groups, cg, 1, 1)

    gf = g.float().reshape(shape)
    dz = torch.where(z >= 0, gf, gf * negative_slope)
    dscale = (dz * xhat).sum(dim=(0, 3, 4)).reshape(c)
    dbias = dz.sum(dim=(0, 3, 4)).reshape(c)

    dxhat = dz * sc
    m1 = dxhat.mean(dim=(2, 3, 4), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(2, 3, 4), keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return (dx.reshape(b, c, h, w).to(x.dtype).contiguous(
        memory_format=torch.channels_last), dscale, dbias)


def _onepass_bwd_layout_ok(c: int, itemsize: int, n_groups: int) -> bool:
    """Whether the one-pass backward's thread layout takes ``c`` channels
    in ``n_groups`` groups: at most 256 channels, 16-byte vectors of V
    channels in a power-of-two count a pixel, each vector within one group
    or a whole number of groups, and the block's rows of partials (double
    statistics, fp32 per-channel sums) within their shared memory (as
    ``msr_gn_onepass_bwd`` checks)."""
    vec = 16 // itemsize
    if c % vec or c > _BWD_MAX_CHANNELS:
        return False
    vpp, cg = c // vec, c // n_groups
    if vpp & (vpp - 1) or (cg % vec and vec % cg):
        return False
    ent = vpp if cg >= vec else c
    prow = _ONEPASS_THREADS // max(vpp, 32)
    return prow * max(2 * ent, c) * 8 <= _BWD_PART_BYTES


@functools.lru_cache(maxsize=None)
def _bwd_capacity(index: int) -> tuple:
    """(co-resident blocks, bytes each can stage of each of x and g) of the
    one-pass backward on CUDA device ``index``, asked once per device."""
    n, stage = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.library().msr_gn_onepass_bwd_capacity(
            ctypes.byref(n), ctypes.byref(stage))
    _build.check(code, "group_norm_leaky_backward (one-pass capacity)")
    return n.value, stage.value


def onepass_backward_plan(x: torch.Tensor, g: torch.Tensor, dx: torch.Tensor,
                          n_groups: int = 8) -> Optional[OnePassPlan]:
    """The one-pass backward's plan for CUDA ``x`` and ``g`` (dx written to
    ``dx``), or None where the shape takes the four-pass route: x, g and dx
    16-byte aligned, the layout taken, one image's x and g on chip."""
    b, c, h, w = x.shape
    if any(t.data_ptr() % 16 for t in (x, g, dx)) or \
            not _onepass_bwd_layout_ok(c, x.element_size(), n_groups):
        return None
    n_blocks, stage = _bwd_capacity(_build.device_index(x.device))
    return _plan_onepass(b, h * w, c, x.element_size(), n_blocks, stage)


def _check_backward(x, scale, bias, g, n_groups):
    _check(x, scale, bias, None, n_groups)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or \
            not g.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("g must match x in shape, dtype, device and "
                         "channels_last layout")


def _onepass_backward(x, scale, bias, g, dx, plan, n_groups, negative_slope,
                      eps):
    b, c, h, w = x.shape
    dev = x.device
    cnt = _build.counters(dev, 2 * b + 1, "group_norm_leaky_backward")
    ws = torch.empty(16 * b * plan.ranges * n_groups + 8 * b * plan.ranges * c
                     + 8 * b * c, dtype=torch.uint8, device=dev)
    grads = torch.empty((2, c), dtype=torch.float32, device=dev)
    code = _build.library().msr_gn_onepass_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        dx.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
        ws.data_ptr(), cnt.data_ptr(), b, h * w, c, n_groups, plan.chunk_px,
        plan.ranges, plan.images_per_wave, plan.waves,
        _bwd_capacity(_build.device_index(dev))[1],
        int(x.dtype == torch.bfloat16), eps, negative_slope,
        _build.stream_ptr(dev))
    group_norm_leaky_backward.launches += 1
    group_norm_leaky_backward.onepass_launches += 1
    _build.check(code, "group_norm_leaky_backward (one-pass)")
    return dx, grads[0], grads[1]


def _fourpass_backward(x, scale, bias, g, dx, n_groups, negative_slope,
                       eps):
    b, c, h, w = x.shape
    vec, rows, chunk_px, nchunks = _launch_geometry(
        h * w, c, x.element_size(),
        all(t.data_ptr() % 16 == 0 for t in (x, g, dx)))
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    ws_stats = torch.empty((b, nchunks, n_groups, 2), dtype=torch.float64,
                           device=dev)
    ws_part = torch.empty((b, nchunks, c, 2), **f32)
    ws_img = torch.empty((b, c, 2), **f32)
    ws_m = torch.empty((b, n_groups, 2), **f32)
    dscale = torch.empty((c,), **f32)
    dbias = torch.empty((c,), **f32)
    code = _build.library().msr_gn_leaky_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
        ws_stats.data_ptr(), ws_part.data_ptr(), ws_img.data_ptr(),
        ws_m.data_ptr(), b, h * w, c, n_groups, chunk_px, nchunks, rows, vec,
        int(x.dtype == torch.bfloat16), eps, negative_slope,
        _build.stream_ptr(dev))
    group_norm_leaky_backward.launches += 1
    _build.check(code, "group_norm_leaky_backward (four-pass)")
    return dx, dscale, dbias


def group_norm_leaky_backward_fourpass(x: torch.Tensor, scale: torch.Tensor,
                                       bias: torch.Tensor, g: torch.Tensor,
                                       n_groups: int = 8,
                                       negative_slope: float = 0.2,
                                       eps: float = GN_EPS) -> tuple:
    """The four-pass kernel on CUDA tensors whatever their shape: what
    :func:`group_norm_leaky_backward` runs where the one-pass route does
    not apply, callable alone so that the two routes can be compared."""
    _check_backward(x, scale, bias, g, n_groups)
    if x.device.type != "cuda":
        raise ValueError(f"the four-pass kernel needs a CUDA tensor, got "
                         f"{x.device}")
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    return _fourpass_backward(x, scale, bias, g, dx, n_groups,
                              negative_slope, eps)


def group_norm_leaky_backward(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, g: torch.Tensor,
                              n_groups: int = 8, negative_slope: float = 0.2,
                              eps: float = GN_EPS) -> tuple:
    """The gradient of :func:`group_norm_leaky` (without the residual's,
    which is ``g``): (dx, dscale, dbias) for the forward's x, scale and
    bias and the output's gradient ``g`` (like x, channels_last). dx takes
    x's dtype and layout, dscale and dbias fp32. On a CUDA tensor the
    one-pass kernel where :func:`onepass_backward_plan` gives a plan, else
    the four-pass kernel; the plain twin on a CPU tensor."""
    _check_backward(x, scale, bias, g, n_groups)
    if x.device.type == "cpu":
        return group_norm_leaky_backward_plain(x, scale, bias, g, n_groups,
                                               negative_slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    plan = onepass_backward_plan(x, g, dx, n_groups)
    if plan is not None:
        return _onepass_backward(x, scale, bias, g, dx, plan, n_groups,
                                 negative_slope, eps)
    return _fourpass_backward(x, scale, bias, g, dx, n_groups,
                              negative_slope, eps)


group_norm_leaky_backward.launches = 0
group_norm_leaky_backward.onepass_launches = 0


def gn_quantize_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      qscale: torch.Tensor, negative_slope: float = 0.2,
                      n_groups: int = 8, eps: float = GN_EPS) -> torch.Tensor:
    return leaky_quantize_plain(
        group_norm_leaky_plain(x, scale, bias, None, n_groups, 1.0, eps),
        qscale, negative_slope)


def gn_quantize(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                qscale: torch.Tensor, negative_slope: float = 0.2,
                n_groups: int = 8, eps: float = GN_EPS) -> torch.Tensor:
    """``leaky_quantize(group_norm_leaky(x, scale, bias, negative_slope=1.0),
    qscale, negative_slope)``: the GroupNorm's affine output cast to x's
    dtype, then LeakyReLU in that dtype and the per-channel int8 quantize.

    x: (B, C, H, W) float32 or bfloat16 in channels_last memory; scale,
    bias, qscale: (C,) float32. Returns int8 (B, C, H, W), channels_last.
    On a CUDA tensor the one-pass kernel with its int8 output where x is
    bf16 and :func:`onepass_plan` gives a plan, else the two kernels in
    turn; the plain version on a CPU tensor. The operator
    ``torch.ops.mri_sr.gn_quantize`` to ``torch.export``
    (``kernels/_ops.py``).
    """
    return _ops.call(_GNQ_OP, _gn_quantize, x, scale, bias, qscale,
                     negative_slope, n_groups, eps)


def _gn_quantize(x, scale, bias, qscale, negative_slope, n_groups, eps):
    _check(x, scale, bias, None, n_groups)
    _check_quantize(x, qscale)
    if x.device.type == "cpu":
        return gn_quantize_plain(x, scale, bias, qscale, negative_slope,
                                 n_groups, eps).contiguous(
            memory_format=torch.channels_last)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        y = _empty_codes(x)
        plan = onepass_plan(x, y, None, n_groups)
        if plan is not None:
            return _onepass(x, scale, bias, None, y, plan, n_groups,
                            negative_slope, eps, qscale=qscale)
    return leaky_quantize(
        group_norm_leaky(x, scale, bias, None, n_groups, 1.0, eps), qscale,
        negative_slope)


def _fake_gn_quantize(x, scale, bias, qscale, negative_slope, n_groups, eps):
    _check(x, scale, bias, None, n_groups)
    _check_quantize(x, qscale)
    return _empty_codes(x)


_GNQ_OP = _ops.register(
    "gn_quantize(Tensor x, Tensor scale, Tensor bias, Tensor qscale, "
    "float negative_slope, int n_groups, float eps) -> Tensor",
    _gn_quantize, _fake_gn_quantize)
gn_quantize.launches = 0
