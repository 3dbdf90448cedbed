"""SwinIR's MLP half of a Swin block in one kernel
(``csrc/swin_mlp.cu``): the LayerNorm, fc1, the exact GELU, fc2 and the
residual add, over rows of Cp channels whose first C are the tokens'.

Replaces no TPU kernel: the JAX package has no transformer. SwinIR's
served forward (``models/swinir.py``) keeps its token stream in rows of C
rounded up to 8 channels (180 -> 184), pad channels zero, and ran the
MLP half of each Swin block as five passes over device memory: the padded
LayerNorm, cuBLAS's fc1, PyTorch's GELU, cuBLAS's fc2 and the add. The
kernel reads each row once and writes it once, and keeps the hidden (360
at the published widths) on the SM:

    out[..., :C]   = x[..., :C] + b2 + W2 GELU(W1 LN(x[..., :C]) + b1)
    out[..., C:Cp] = 0

LN takes its mean and variance over the first C channels in fp32 with
the fp32 scale and shift and rounds once to bf16 (GEMM1's operand); the
GEMMs sum in fp32; b1 and the GELU are fp32, the hidden rounded once to
bf16 (GEMM2's operand); b2 and the residual are added in fp32 and the row
rounded once. :func:`swin_mlp_plain` is that arithmetic in PyTorch ops;
the wrapper takes it for a CPU tensor. The kernel sums in another order,
so the two agree to bf16 rounding, not bit for bit.

The kernel's bound is operations, 4 C hidden a row (the unpadded work),
at the card's bf16 peak; its bytes (each row's C channels read once and
written once) bind less. The weights are cast to bf16 and laid out in the
kernel's order on each call (:func:`packed_weights`), as the unfused
path casts them, and nothing is kept on the module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.utils.spans import span

# channels of one 16-byte vector of bf16: a row's unit
CHANNEL_MULTIPLE = 8
# the row width Cp the kernel is built for (SwinIR classical's 184), and
# its widest hidden (the published 360 in chunks of 64)
ROW_WIDTH = 184
MAX_HIDDEN = 384
# hidden columns of one stage of the kernel's weights
CHUNK = 64
# the span of each launch while a profiler runs, which counts its rows
LAUNCH_SPAN = "kernel.swin_mlp"


def serves(cp: int, hidden: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes rows of ``cp`` channels into a hidden of
    ``hidden`` in ``dtype``."""
    return dtype == torch.bfloat16 and cp == ROW_WIDTH and \
        1 <= hidden <= MAX_HIDDEN


def _zero_padded(t: torch.Tensor, shape) -> torch.Tensor:
    out = t.new_zeros(shape, dtype=torch.bfloat16)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def packed_weights(w1: torch.Tensor, w2: torch.Tensor,
                   cp: int) -> torch.Tensor:
    """fc1's weight (hidden, C) and fc2's (C, hidden) in bf16, in the
    kernel's layout: a row per chunk of 64 hidden columns (zero past
    hidden), W1's 64 rows (K = cp rounded up to 16 columns, zero past C)
    in K-blocks of 64 channels, then W2's Cp rows of the chunk's 64; each
    row 128 bytes with wgmma's 128-byte swizzle: row n's 8-channel group
    g at group g ^ (n % 8)."""
    hidden = w1.shape[0]
    kp = -(-cp // 16) * 16
    chunks = -(-hidden // CHUNK)
    a = _zero_padded(w1.detach(), (chunks * CHUNK, kp))
    b = _zero_padded(w2.detach(), (cp, chunks * CHUNK))
    # 128-byte swizzle: in each atom of 8 rows of 64 channels, row n's
    # 16-byte chunk c lies at chunk c ^ (n % 8)
    a = a.view(chunks, CHUNK, kp // 64, 8, 8).permute(0, 2, 1, 3, 4)
    b = b.view(cp, chunks, 8, 8).permute(1, 0, 2, 3)
    ia = (torch.arange(8, device=a.device)[None, :] ^
          (torch.arange(CHUNK, device=a.device)[:, None] % 8))
    ib = (torch.arange(8, device=a.device)[None, :] ^
          (torch.arange(cp, device=a.device)[:, None] % 8))
    a = torch.gather(a, 3, ia[None, None, :, :, None].expand(a.shape))
    b = torch.gather(b, 2, ib[None, :, :, None].expand(b.shape))
    return torch.cat([a.reshape(chunks, -1), b.reshape(chunks, -1)], 1)


def swin_mlp_plain(x: torch.Tensor, norm: nn.LayerNorm, fc1: nn.Linear,
                   fc2: nn.Linear, c: int) -> torch.Tensor:
    """The MLP half of a Swin block on the first ``c`` channels of each
    row of ``x`` (..., Cp), as the kernel computes it: the LayerNorm in
    fp32 rounded to x's dtype, fc1 on weights in x's dtype summed in fp32
    plus the fp32 bias, the GELU in fp32 rounded to x's dtype, fc2 the
    same way, plus the fp32 bias and the residual, rounded once; the rows
    of Cp with channels from c on zero."""
    dt = x.dtype
    xf = x[..., :c].float()
    n = F.layer_norm(xf, (c,), norm.weight.float(), norm.bias.float(),
                     norm.eps).to(dt).float()
    h = F.linear(n, fc1.weight.to(dt).float(), fc1.bias.float())
    h = F.gelu(h).to(dt).float()
    y = F.linear(h, fc2.weight.to(dt).float(), fc2.bias.float()) + xf
    return F.pad(y, (0, x.shape[-1] - c)).to(dt)


def _check(x, norm, fc1, fc2, c):
    cp = x.shape[-1] if x.dim() else 0
    if cp % CHANNEL_MULTIPLE or not 1 <= c <= cp:
        raise ValueError(f"rows of x must be a multiple of "
                         f"{CHANNEL_MULTIPLE} channels, at least C = {c}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"swin_mlp takes bfloat16 rows, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x's rows must be contiguous (a row stride of its "
                         "last axis)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    hidden = fc1.out_features
    if norm.normalized_shape != (c,) or fc1.in_features != c or \
            fc2.in_features != hidden or fc2.out_features != c:
        raise ValueError(f"norm, fc1 and fc2 must map C = {c} channels "
                         f"through one hidden and back")
    params = (norm.weight, norm.bias, fc1.weight, fc1.bias, fc2.weight,
              fc2.bias)
    if any(p.device != x.device for p in params):
        raise ValueError(f"the weights must lie on {x.device}")
    if _build.needs_grad(x, *params):
        raise RuntimeError("swin_mlp has no backward: call it with grad off")


def _launch(x, norm, fc1, fc2, c):
    cp, hidden = x.shape[-1], fc1.out_features
    if not serves(cp, hidden, x.dtype):
        raise ValueError(f"the kernel takes rows of {ROW_WIDTH} channels "
                         f"and a hidden of 1 to {MAX_HIDDEN}, got {cp} and "
                         f"{hidden}")
    w = packed_weights(fc1.weight, fc2.weight, cp)
    gamma, beta, b1, b2 = (t.detach().float().contiguous() for t in (
        norm.weight, norm.bias, fc1.bias, fc2.bias))
    out = torch.empty_like(x)
    rows = x.numel() // cp
    with span(LAUNCH_SPAN, count=rows):
        code = _build.library().msr_swin_mlp(
            x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            b1.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, c, cp,
            hidden, norm.eps, _build.stream_ptr(x.device))
    swin_mlp.launches += 1
    _build.check(code, "swin_mlp")
    return out


def swin_mlp(x: torch.Tensor, norm: nn.LayerNorm, fc1: nn.Linear,
             fc2: nn.Linear, c: int) -> torch.Tensor:
    """``x + fc2(GELU(fc1(norm(x))))`` over the first C = ``c`` channels
    of each row of ``x`` (..., Cp), in a new tensor of rows of Cp whose
    channels from c on are zero. x bf16, contiguous, 16-byte aligned, Cp a
    multiple of 8; no gradient. On a CUDA tensor the kernel (Cp and the
    hidden as :func:`serves` says, else it raises), on a CPU tensor the
    plain version."""
    _check(x, norm, fc1, fc2, c)
    if x.device.type == "cpu":
        return swin_mlp_plain(x, norm, fc1, fc2, c)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, norm, fc1, fc2, c)


swin_mlp.launches = 0


def flops(rows: int, c: int, hidden: int) -> int:
    """Operations of one call, the unpadded work: fc1 and fc2, 2 C hidden
    multiply-adds a row."""
    return rows * 4 * c * hidden


def bytes_moved(rows: int, c: int, elem: int = 2) -> int:
    """Bytes one call must move: each row's C channels read once and
    written once."""
    return rows * 2 * c * elem
