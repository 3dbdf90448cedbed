"""Fused LeakyReLU + per-channel int8 quantize: kernel B4.

Replaces the TPU kernel ``tools/bench_int8_probe4.py``
(``leaky_quantize_pallas``). The CUDA source is ``csrc/leaky_quantize.cu``;
its note says what bounds it on the H100 (bytes) and why the TPU kernel's
pre-tiled ``(W*C,)`` scale row is not kept. The plain version below is the
definition the kernel matches code for code: LeakyReLU in x's dtype, an
fp32 division by the channel's scale, round half to even, clamp to +-127.
With ``negative_slope=1.0`` it is exactly ``ops.quant.quantize_tensor``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


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


def leaky_quantize(x: torch.Tensor, scale: torch.Tensor,
                   negative_slope: float = 0.2) -> torch.Tensor:
    """``clip(round(leaky_relu(x, negative_slope) / scale[c]), +-127)``.

    x: (B, C, H, W) bfloat16 or float32 in channels_last memory; scale:
    (C,) float32. Returns int8 (B, C, H, W), channels_last. The kernel on a
    CUDA tensor, the plain version on a CPU tensor.
    """
    _check(x, scale)
    if x.device.type == "cpu":
        return leaky_quantize_plain(x, scale, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device,
                    memory_format=torch.channels_last)
    n = x.numel()
    vec = 16 // x.element_size()
    if n % vec or x.data_ptr() % 16 or y.data_ptr() % vec:
        vec = 1
    code = _build.library().msr_leaky_quantize(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), n, x.shape[1], vec,
        int(x.dtype == torch.bfloat16), negative_slope,
        _build.stream_ptr(x.device))
    leaky_quantize.launches += 1
    _build.check(code, "leaky_quantize")
    return y


leaky_quantize.launches = 0
