"""Fused LeakyReLU + per-channel int8 quantize: kernel B4.

Replaces the TPU kernel ``tools/bench_int8_probe4.py``
(``leaky_quantize_pallas``). The CUDA source is ``csrc/leaky_quantize.cu``,
with the per-element arithmetic in ``csrc/quantize.cuh``; its note says why
B4 is bound by the SMs' issue rate rather than bytes, and why the TPU
kernel's pre-tiled ``(W*C,)`` scale row is not kept. On a CUDA tensor two
kernels serve it, chosen by shape (:func:`_route`):

- the stream kernel: bf16 x with C a power of two up to
  :data:`STREAM_MAX_C`, x and the codes 16-byte aligned, a multiple of 16
  elements (every unet site); no division, rounding or conversion
  instruction per element;
- the element kernel (:func:`leaky_quantize_generic`) for every other
  shape and for fp32 x.

At the unet's seven DoubleConv ``conv2`` sites the same arithmetic runs
inside B1's one-pass kernel (``kernels.groupnorm.gn_quantize``).

The plain version below is the definition both kernels match code for
code: LeakyReLU in x's dtype, an fp32 division by the channel's scale,
round half to even, clamp to +-127. With ``negative_slope=1.0`` it is
exactly ``ops.quant.quantize_tensor``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
# the stream kernel's threads a block and elements a thread
_STREAM_THREADS = 256
_STREAM_ELEMS = 16
# the largest C whose channels stay fixed per thread: one block's step
STREAM_MAX_C = _STREAM_THREADS * _STREAM_ELEMS


def leaky_quantize_plain(x: torch.Tensor, scale: torch.Tensor,
                         negative_slope: float = 0.2) -> torch.Tensor:
    s = scale.view(1, -1, *([1] * (x.dim() - 2)))
    y = torch.round(F.leaky_relu(x, negative_slope).float() / s)
    return y.clamp(-127.0, 127.0).to(torch.int8)


def _check(x, scale):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (make the layout "
                         "right at the call site)")
    c = x.shape[1]
    if scale.shape != (c,) or scale.dtype != torch.float32 or \
            scale.device != x.device or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous float32 ({c},) tensor "
                         f"on {x.device}")


def _element_vec(dtype: torch.dtype, n: int, x_ptr: int, y_ptr: int) -> int:
    """The element kernel's elements a thread: one 16-byte vector of x, or
    1 where the size or an address does not allow it."""
    vec = 16 // dtype.itemsize
    return 1 if n % vec or x_ptr % 16 or y_ptr % vec else vec


def _route(c: int, dtype: torch.dtype, n: int, x_ptr: int,
           y_ptr: int) -> tuple:
    """``("stream", 16)`` where the stream kernel takes ``n`` elements of
    ``c`` channels at these addresses, else ``("element", vec)``."""
    c_ok = 1 <= c <= STREAM_MAX_C and c & (c - 1) == 0
    if dtype == torch.bfloat16 and c_ok and n % _STREAM_ELEMS == 0 and \
            x_ptr % 16 == 0 and y_ptr % 16 == 0:
        return "stream", _STREAM_ELEMS
    return "element", _element_vec(dtype, n, x_ptr, y_ptr)


def _empty_codes(x):
    return torch.empty(x.shape, dtype=torch.int8, device=x.device,
                       memory_format=torch.channels_last)


def _element(x, scale, y, vec, negative_slope):
    code = _build.library().msr_leaky_quantize(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.numel(), x.shape[1],
        vec, int(x.dtype == torch.bfloat16), negative_slope,
        _build.stream_ptr(x.device))
    leaky_quantize.launches += 1
    _build.check(code, "leaky_quantize (element)")
    return y


def leaky_quantize(x: torch.Tensor, scale: torch.Tensor,
                   negative_slope: float = 0.2) -> torch.Tensor:
    """``clip(round(leaky_relu(x, negative_slope) / scale[c]), +-127)``.

    x: (B, C, H, W) bfloat16 or float32 in channels_last memory; scale:
    (C,) float32. Returns int8 (B, C, H, W), channels_last. On a CUDA
    tensor the stream kernel where :func:`_route` allows it, else the
    element kernel; the plain version on a CPU tensor.
    """
    _check(x, scale)
    if x.device.type == "cpu":
        return leaky_quantize_plain(x, scale, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = _empty_codes(x)
    route, vec = _route(x.shape[1], x.dtype, x.numel(), x.data_ptr(),
                        y.data_ptr())
    if route == "element":
        return _element(x, scale, y, vec, negative_slope)
    code = _build.library().msr_leaky_quantize_stream(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.numel(), x.shape[1],
        negative_slope, _build.stream_ptr(x.device))
    leaky_quantize.launches += 1
    leaky_quantize.stream_launches += 1
    _build.check(code, "leaky_quantize (stream)")
    return y


def leaky_quantize_generic(x: torch.Tensor, scale: torch.Tensor,
                           negative_slope: float = 0.2) -> torch.Tensor:
    """The element kernel on a CUDA ``x`` whatever its shape: what
    :func:`leaky_quantize` runs where the stream kernel does not apply,
    callable alone so that the two can be compared."""
    _check(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"the element kernel needs a CUDA tensor, got "
                         f"{x.device}")
    y = _empty_codes(x)
    return _element(x, scale, y, _element_vec(x.dtype, x.numel(),
                                              x.data_ptr(), y.data_ptr()),
                    negative_slope)


leaky_quantize.launches = 0
leaky_quantize.stream_launches = 0
