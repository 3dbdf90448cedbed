"""Narrow-Cout 3x3 convolution: kernel B3.

Replaces the TPU kernel ``experiments/conv_pallas.py``
(``conv3x3_packed_fwd``). The CUDA source is ``csrc/conv3x3_narrow.cu``;
its note says what bounds it on the H100 and how it is built. Stride 1,
zero padding 1, no bias; inputs and weights of one dtype, fp32
accumulation. The plain version is ``F.conv2d`` with fp32 accumulation
made explicit: inputs cast to fp32, the result cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_COUT = 64


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x.float(), weight.float(), padding=1).to(x.dtype)


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
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (make the layout "
                         "right at the call site)")


def conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3x3 conv, stride 1, zero pad 1, no bias.

    x: (B, Ci, H, W) float32 or bfloat16 in channels_last memory; weight:
    (Co, Ci, 3, 3), Co a multiple of 8 up to 64. Returns (B, Co, H, W) in
    x's dtype, channels_last. The kernel on a CUDA tensor, the plain version
    on a CPU tensor.
    """
    _check(x, weight)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, ci, h, w = x.shape
    co = weight.shape[0]
    w_hwio = weight.permute(2, 3, 1, 0).contiguous()        # (3, 3, Ci, Co)
    y = torch.empty((b, co, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    code = _build.library().msr_conv3x3_fwd(
        x.data_ptr(), w_hwio.data_ptr(), y.data_ptr(), b, h, w, ci, co,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    conv3x3.launches += 1
    _build.check(code, "conv3x3")
    return y


conv3x3.launches = 0
