"""Narrow-Cout 3x3 convolution: kernel B3.

Replaces the TPU kernel ``experiments/conv_pallas.py``
(``conv3x3_packed_fwd``). Stride 1, zero padding 1, no bias; inputs and
weights of one dtype, fp32 accumulation. On a CUDA tensor bf16 runs the
tensor-core implicit GEMM of ``csrc/conv3x3_mma.cu`` and fp32 the
CUDA-core kernel of ``csrc/conv3x3_narrow.cu``; their notes say what
bounds them on the H100. Both read the weights packed as (Co, 9, Ci)
(:func:`pack_weight`), a view with no copy when the weight is
channels_last, as the unet casts it. The bf16 kernel sums over K chunk by
chunk of :func:`k_chunk` input channels (zero-padded past Ci), within a
chunk over dw, then over dh. The plain version is ``F.conv2d`` with fp32
accumulation made explicit: inputs cast to fp32, the result cast back.

Where autograd needs it, :func:`conv3x3` runs as a
``torch.autograd.Function``: the same forward, and a backward from
PyTorch's convolution gradients (``aten.convolution_backward``, what
``torch.nn.grad.conv2d_input`` / ``conv2d_weight`` call, with padding 1),
as the JAX package's ``custom_vjp`` takes its backward from XLA's conv
VJP. On the card they run in x's dtype; on the CPU bf16 goes through
fp32, as the plain forward does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build, _ops

_DTYPES = (torch.float32, torch.bfloat16)
MAX_COUT = 64


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x.float(), weight.float(), padding=1).to(x.dtype)


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) -> the kernels' (Co, 9, Ci), tap = 3 * dh + dw."""
    co, ci = weight.shape[:2]
    return weight.permute(0, 2, 3, 1).reshape(co, 9, ci).contiguous()


def k_chunk(ci: int) -> int:
    """Input channels the bf16 kernel stages and sums at a time."""
    return 16 if ci <= 16 else 32


def _check(x, weight):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, Ci, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    co, ci = weight.shape[0], x.shape[1]
    if weight.shape != (co, ci, 3, 3):
        raise ValueError(f"weight must be (Co, {ci}, 3, 3), got "
                         f"{tuple(weight.shape)}")
    if co % 8 or co > MAX_COUT:
        raise ValueError(f"Co must be a multiple of 8 up to {MAX_COUT}, "
                         f"got {co}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise ValueError("weight must share x's dtype and device")
    if not _build.channels_last(x):
        raise ValueError("x must be channels_last contiguous (make the layout "
                         "right at the call site)")


def _forward(x, weight):
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight).contiguous(
            memory_format=torch.channels_last)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, ci, h, w = x.shape
    co = weight.shape[0]
    wp = pack_weight(weight)
    y = torch.empty((b, co, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib, stream = _build.library(), _build.stream_ptr(x.device)
    if x.dtype == torch.bfloat16:
        code = lib.msr_conv3x3_bf16(x.data_ptr(), wp.data_ptr(), y.data_ptr(),
                                    b, h, w, ci, co, k_chunk(ci), stream)
    else:
        code = lib.msr_conv3x3_f32(x.data_ptr(), wp.data_ptr(), y.data_ptr(),
                                   b, h, w, ci, co, stream)
    conv3x3.launches += 1
    _build.check(code, "conv3x3")
    return y


def conv3x3_backward(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                     mask=(True, True)) -> tuple:
    """(dx, dweight) of :func:`conv3x3` for the output's gradient ``g``,
    each None where ``mask`` says it is not needed: PyTorch's convolution
    gradients, in x's dtype (through fp32 for bf16 on the CPU)."""
    dt = x.dtype
    if x.device.type == "cpu" and dt != torch.float32:
        x, weight, g = x.float(), weight.float(), g.float()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [mask[0], mask[1], False])
    return (None if dx is None else dx.to(dt),
            None if dw is None else dw.to(dt))


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return _forward(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return conv3x3_backward(x, weight, g, ctx.needs_input_grad)


def conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3x3 conv, stride 1, zero pad 1, no bias.

    x: (B, Ci, H, W) float32 or bfloat16 in channels_last memory; weight:
    (Co, Ci, 3, 3), Co a multiple of 8 up to 64. Returns (B, Co, H, W) in
    x's dtype, channels_last. A kernel on a CUDA tensor (tensor cores for
    bf16, CUDA cores for fp32), the plain version on a CPU tensor.
    Differentiable: see the module's note. Without a gradient to keep, it
    is the operator ``torch.ops.mri_sr.conv3x3`` to ``torch.export``
    (``kernels/_ops.py``).
    """
    if _build.needs_grad(x, weight):
        _check(x, weight)
        return _Conv3x3.apply(x, weight)
    return _ops.call(_OP, _op_forward, x, weight)


def _op_forward(x, weight):
    _check(x, weight)
    return _forward(x, weight)


def _fake(x, weight):
    _check(x, weight)
    b, _, h, w = x.shape
    return torch.empty((b, weight.shape[0], h, w), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


_OP = _ops.register("conv3x3(Tensor x, Tensor weight) -> Tensor",
                    _op_forward, _fake)
conv3x3.launches = 0
