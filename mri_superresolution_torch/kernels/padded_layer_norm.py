"""LayerNorm over the first C channels of wider rows, the rest written as
zeros (``csrc/padded_layer_norm.cu``).

Replaces no TPU kernel: the JAX package has no LayerNorm. SwinIR's served
forward (``models/swinir.py``) keeps its C-wide token stream in rows of
Cp channels, C rounded up to a 16-byte row of bf16 (180 -> 184), so that
its GEMMs and convs take cuBLAS's and cuDNN's aligned Hopper kernels. Each
of its LayerNorms (74 a forward at the published widths) normalises the
first C channels of such a row and must leave the pad at zero, which
``F.layer_norm`` cannot: it normalises the whole last axis.

The kernel's bound is bytes, rows x 2 x Cp x 2 B (read once, written once)
at 3.35 TB/s. The plain version below is the same function in PyTorch
ops; the wrapper takes it for a CPU tensor. The kernel takes the mean and
variance in fp32 in its own order, so the two agree to bf16 rounding, not
bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.utils.spans import span

# channels of one 16-byte vector of bf16: a row's unit
CHANNEL_MULTIPLE = 8
# the widest row the kernel takes: 8 threads a row, 8 vectors each
MAX_WIDTH = 512
# the span of each launch while a profiler runs, which counts its rows
LAUNCH_SPAN = "kernel.swin_layer_norm"


def padded_layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``F.layer_norm`` of the first C = ``weight.numel()`` channels of
    each row of ``x`` in fp32, then the rows of x's width with channels
    from C on zero, in x's dtype."""
    c = weight.numel()
    y = F.layer_norm(x[..., :c].float(), (c,), weight.float(), bias.float(),
                     eps)
    return F.pad(y, (0, x.shape[-1] - c)).to(x.dtype)


def _check(x, weight, bias):
    c, cp = weight.numel(), x.shape[-1] if x.dim() else 0
    if cp % CHANNEL_MULTIPLE or not 1 <= c <= cp:
        raise ValueError(f"rows of x must be a multiple of "
                         f"{CHANNEL_MULTIPLE} channels, at least C = {c}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x's rows must be contiguous (a row stride of its "
                         "last axis)")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}")
    if _build.needs_grad(x, weight, bias):
        raise RuntimeError("padded_layer_norm has no backward: call it with "
                           "grad off")


def _launch(x, weight, bias, eps):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {x.dtype}")
    if x.shape[-1] > MAX_WIDTH:
        raise ValueError(f"rows wider than {MAX_WIDTH} channels, got "
                         f"{x.shape[-1]}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    with span(LAUNCH_SPAN, count=rows):
        code = _build.library().msr_padded_layer_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, weight.numel(), x.shape[-1], eps,
            _build.stream_ptr(x.device))
    padded_layer_norm.launches += 1
    _build.check(code, "padded_layer_norm")
    return out


def padded_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm of the first C = ``weight.numel()`` channels of each row
    of ``x`` (..., Cp), statistics in fp32, then ``weight`` and ``bias``
    (fp32, (C,)); returns rows of Cp with channels C .. Cp - 1 zero,
    whatever x holds there. Cp a multiple of 8, x contiguous; no gradient.
    On a CUDA tensor the kernel (bf16, 16-byte aligned, Cp up to 512), on
    a CPU tensor the plain version."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return padded_layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, weight, bias, eps)


padded_layer_norm.launches = 0


def bytes_moved(rows: int, width: int, elem: int = 2) -> int:
    """Bytes one call must move: each row of ``width`` channels read once
    and written once."""
    return rows * 2 * width * elem
