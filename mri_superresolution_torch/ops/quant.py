"""int8 post-training-quantization primitives for serving on the GPU.

An own copy of the JAX package's ``ops/quant.py``: the serving half, and
the float simulation of it that quantization-aware training runs
(``ste``, ``fake_quant_act``, ``fake_quant_kernel``).

Scheme (symmetric PTQ):
- weights: per-output-channel symmetric int8, scale = amax(|w|)/127 over
  (kh, kw, cin), quantized once when the scales freeze;
- activations: per-INPUT-channel symmetric int8 with static scales from a
  calibration pass (``models/quant_forward.py``), folded into the weights
  by ``weight_qparams(act_scale=...)`` so the dequant needs only the
  per-Cout weight scale;
- accumulation: exact int32 (``torch._int_mm``), dequantized as
  float32 * s_w[cout] [+ bias] and cast to the serving dtype.

Activations are NCHW-indexed tensors in ``channels_last`` memory (NHWC
bytes), as everywhere in the port; kernels are HWIO, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Per-pixel intensity above which a pixel counts as foreground: the int8
# engine routes batches with too few such pixels to bf16.
FOREGROUND_INTENSITY = 0.05

CL = torch.channels_last


def quantize_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization with a static scale: a scalar, or a
    (C,) vector over the channel axis (dim 1) of an NCHW-indexed tensor.
    ``round(x / s)`` in fp32, half to even, clipped to +-127."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if s.dim() == 1:
        s = s.view(1, -1, *([1] * (x.dim() - 2)))
    q = torch.round(x.float() / s)
    return q.clamp(-127.0, 127.0).to(torch.int8)


def weight_qparams(weight: torch.Tensor, act_scale=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of an OIHW conv
    weight.

    ``act_scale`` (scalar or (Cin,)) folds the activation quantization into
    the weights: with q_x = x / s_a and w' = w * s_a per input channel,
    sum(q_x * w') == sum(x * w) / s_w, so the conv's dequant needs only the
    returned per-Cout weight scale.

    Returns (q_kernel int8 HWIO (kh, kw, Cin, Cout), the layout
    :func:`int8_conv` takes; scale float32 (Cout,)). All-zero output
    channels get scale 1 (their quantized weights are 0 either way).
    """
    k = weight.float().permute(2, 3, 1, 0)                 # HWIO
    if act_scale is not None:
        k = k * torch.as_tensor(act_scale, dtype=torch.float32,
                                device=k.device).reshape(1, 1, -1, 1)
    amax = k.abs().amax(dim=(0, 1, 2))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(k / scale).clamp(-127.0, 127.0).to(torch.int8)
    return q.contiguous(), scale


def ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the value of ``q``, the gradient of
    ``x``. The JAX package's expression, ``x + stop_gradient(q - x)``, in
    x's dtype (in bf16 each of its two ops rounds)."""
    return x + (q.to(x.dtype) - x).detach()


def _channel_view(s: torch.Tensor, dim: int, ndim: int) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over axis ``dim`` of ``ndim``."""
    if s.dim() == 0:
        return s
    shape = [1] * ndim
    shape[dim] = -1
    return s.reshape(shape)


def fake_quant_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize-dequantize simulation of :func:`quantize_tensor`: the value
    the int8 conv effectively consumes (round half to even, clip to +-127,
    re-scale), in x's dtype. ``scale``: a scalar or a (C,) vector over the
    channel axis (dim 1) of an NCHW-indexed tensor."""
    s = _channel_view(torch.as_tensor(scale, dtype=torch.float32,
                                      device=x.device), 1, x.dim())
    q = torch.round(x.float() / s).clamp(-127.0, 127.0)
    return (q * s).to(x.dtype)


def fake_quant_kernel(weight: torch.Tensor, act_scale) -> torch.Tensor:
    """Float simulation of the weights the int8 conv multiplies by, for an
    OIHW weight: :func:`weight_qparams`'s fold of ``act_scale`` (per input
    channel), per-output-channel quantize, dequantize, unfold. So
    ``conv(fake_quant_act(x, s), fake_quant_kernel(w, s))`` is
    ``int8_conv(quantize_tensor(x, s), *weight_qparams(w, s))`` up to the
    order of the fp32 sums. All-zero output channels get weight scale 1,
    as in :func:`weight_qparams`."""
    s_a = _channel_view(torch.as_tensor(act_scale, dtype=torch.float32,
                                        device=weight.device), 1, 4)
    kf = weight.float() * s_a
    amax = kf.abs().amax(dim=(1, 2, 3), keepdim=True)
    s_w = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(kf / s_w).clamp(-127.0, 127.0)
    return ((q * s_w) / s_a).to(weight.dtype)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _im2col(qx: torch.Tensor, kh: int, kw: int, padding: int) -> torch.Tensor:
    """(B, C, H, W) channels_last int8 -> (B*Ho*Wo, kh*kw*C) patch rows,
    ordered (dy, dx, c) like a flattened HWIO kernel's rows."""
    x = qx.permute(0, 2, 3, 1)                              # NHWC view
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    x = x.contiguous()
    b, hp, wp, c = x.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    if kh == kw == 1:
        return x.reshape(b * ho * wo, c)
    sb, sh, sw, _ = x.stride()
    patches = x.as_strided((b, ho, wo, kh, kw, c), (sb, sh, sw, sh, sw, 1))
    return patches.reshape(b * ho * wo, kh * kw * c)


def int8_conv(qx: torch.Tensor, qk: torch.Tensor, k_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, padding: int = 0,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """s8 x s8 -> s32 conv (stride 1), dequantized to ``out_dtype``.

    qx: (B, Cin, H, W) int8, channels_last; qk: (kh, kw, Cin, Cout) int8
    with the activation scale folded in (:func:`weight_qparams`); k_scale:
    (Cout,) float32. The conv is one ``torch._int_mm`` over im2col rows,
    exact in int32; then y = s32 * k_scale [+ bias]. ``_int_mm`` on the
    card wants more than 16 rows and K, N multiples of 8: rows, K and N are
    zero-padded to that on every device (exact) and cropped after.
    Returns (B, Cout, Ho, Wo) channels_last.
    """
    kh, kw, cin, cout = qk.shape
    if qx.shape[1] != cin:
        raise ValueError(f"qx has {qx.shape[1]} channels, kernel wants {cin}")
    cols = _im2col(qx, kh, kw, padding)
    b = qx.shape[0]
    ho = qx.shape[2] + 2 * padding - kh + 1
    wo = qx.shape[3] + 2 * padding - kw + 1
    m, k = cols.shape
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(cout, 8)
    if (mp, kp) != (m, k):
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    wmat = qk.reshape(k, cout)
    if (kp, np_) != (k, cout):
        wmat = F.pad(wmat, (0, np_ - cout, 0, kp - k))
    # the weights go in column-major: cuBLASLt's int8 GEMM on the H100
    # refuses row-major ones at K <= 64 with N >= 32, and takes this
    # layout at every shape of the unet
    acc = torch._int_mm(cols, wmat.t().contiguous().t())[:m, :cout]
    y = acc.float() * k_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(b, ho, wo, cout).permute(0, 3, 1, 2) \
        .contiguous(memory_format=CL)
