"""A conv's pointwise tail in one pass: bias, ReLU, a scale and a residual
add over the conv's channels-last output (``csrc/bias_epilogue.cu``).

Replaces no TPU kernel: XLA fuses a conv's bias, activation and residual
add into the conv itself, while on the card the port's convs are cuDNN's
``F.conv2d``, after which PyTorch ran the bias (a broadcast add that takes
its unvectorized elementwise kernel over a channels-last tensor), the ReLU,
the multiply by ``res_scale`` and the residual add as passes of their own.
EDSR's served forward (``models/edsr.py``) calls its convs without a bias
and this kernel after each, where :func:`serves` and its grad mode allow.

The plain version below is the definition the kernel matches bit for bit:
each step one fp32 operation, rounded once to y's dtype at the end.
"""

from __future__ import annotations

import torch

from mri_superresolution_torch.kernels import _build, _ops

_DTYPES = (torch.bfloat16, torch.float32)
# channels of one 16-byte vector of bf16: the kernel's unit, 8 channels at
# a time, and its alignment
CHANNEL_MULTIPLE = 8


def serves(c: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes a tensor of ``c`` channels of ``dtype``."""
    return c % CHANNEL_MULTIPLE == 0 and dtype in _DTYPES


def bias_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        residual: torch.Tensor = None, relu: bool = False,
                        scale: float = 1.0) -> torch.Tensor:
    t = y.float() + bias.view(1, -1, 1, 1)
    if relu:
        t = torch.relu(t)
    t = t * scale
    if residual is not None:
        t = residual.float() + t
    return t.to(y.dtype).contiguous(memory_format=torch.channels_last)


def _check(y, bias, residual):
    if y.dim() != 4:
        raise ValueError(f"y must be (B, C, H, W), got {tuple(y.shape)}")
    c = y.shape[1]
    if not serves(c, y.dtype):
        raise ValueError(f"y must be float32 or bfloat16 with C a multiple "
                         f"of {CHANNEL_MULTIPLE}, got {y.dtype}, C = {c}")
    if not _build.channels_last(y):
        raise ValueError("y must be channels_last contiguous (make the layout "
                         "right at the call site)")
    if bias.shape != (c,) or bias.dtype != torch.float32 or \
            bias.device != y.device or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous float32 ({c},) tensor "
                         f"on {y.device}")
    if residual is not None and (
            residual.shape != y.shape or residual.dtype != y.dtype or
            residual.device != y.device or
            not _build.channels_last(residual)):
        raise ValueError("residual must be a channels_last tensor of y's "
                         "shape, dtype and device")
    if _build.needs_grad(y, bias, residual):
        raise RuntimeError("bias_epilogue has no backward: call it with "
                           "grad off")


def _bias_epilogue(y, bias, residual, relu, scale, out=None):
    _check(y, bias, residual)
    if y.device.type == "cpu":
        want = bias_epilogue_plain(y, bias, residual, relu, scale)
        return want if out is None else out.copy_(want)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if out is None:
        out = torch.empty_like(y, memory_format=torch.channels_last)
    ptrs = [t.data_ptr() for t in (y, residual, out) if t is not None]
    if any(p % 16 for p in ptrs):
        raise ValueError("y, residual and out must be 16-byte aligned")
    code = _build.library().msr_bias_epilogue(
        y.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        y.numel(), y.shape[1], int(y.dtype == torch.bfloat16), int(relu),
        scale, _build.stream_ptr(y.device))
    bias_epilogue.launches += 1
    _build.check(code, "bias_epilogue")
    return out


def bias_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor = None, relu: bool = False,
                  scale: float = 1.0, inplace: bool = False) -> torch.Tensor:
    """``[residual +] scale * act(y + bias[c])``, ``act`` ReLU where
    ``relu``, in fp32, rounded once to y's dtype.

    y: (B, C, H, W) bfloat16 or float32 in channels_last memory, C a
    multiple of 8 (:func:`serves`); bias: (C,) float32; residual: y's
    shape, dtype and layout, or None. Returns a channels_last tensor, y
    itself where ``inplace``. No gradient: it refuses inputs that require
    one. On a CUDA tensor the kernel (16-byte aligned tensors), on a CPU
    tensor the plain version. The operator
    ``torch.ops.mri_sr.bias_epilogue`` to ``torch.export``
    (``kernels/_ops.py``), which writes a new tensor.
    """
    if torch.compiler.is_compiling():
        return _OP(y, bias, residual, relu, scale)
    return _bias_epilogue(y, bias, residual, relu, scale,
                          y if inplace else None)


def _fake(y, bias, residual, relu, scale):
    _check(y, bias, residual)
    return torch.empty_like(y, memory_format=torch.channels_last)


_OP = _ops.register("bias_epilogue(Tensor y, Tensor bias, Tensor? residual, "
                    "bool relu, float scale) -> Tensor", _bias_epilogue, _fake)
bias_epilogue.launches = 0
