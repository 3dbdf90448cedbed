"""SwinIR's shifted-window attention in one pass over the qkv linear's
output (``csrc/window_attention.cu``).

Replaces no TPU kernel: the JAX package has no attention. The published
SwinIR (Liang et al. 2021, ``models/network_swinir.py``) rolls the tokens
by -shift, cuts them into windows, reshapes q, k and v by head,
materializes each window's and head's scores, adds the relative-position
bias gathered from its (2w - 1)^2 x heads table and, in a shifted block,
the region mask, takes the softmax, multiplies by v, and puts the windows
back and rolls them by +shift. The kernel does all of that in one launch,
from the qkv linear's output (B, H, W, 3C) in the token layout to the
attention output (B, H, W, C) at the tokens' own positions: the roll and
the windowing are index arithmetic, the bias index and the mask come from
the tokens' coordinates.

The served forward keeps its rows 16 bytes wide: qkv in rows of 3C
rounded up to 8 channels, the output in rows of C rounded up (``dim`` and
``out_width``); the kernel reads the first 3C channels of each qkv row and
writes zeros into the output's channels from C on.

The plain version below is that published sequence in PyTorch ops, which
autograd knows: training, the CPU and every differentiated call take it.
``window_attention`` takes the kernel with grad off, on a CUDA tensor, for
what :func:`serves` (bf16, windows of 8 shifted by 0 or 4, an even head
size up to 32).
The kernel rounds P to bf16 before P @ v on its tensor cores, as the plain
version does in bf16, and sums in fp32: they agree to bf16 rounding, not
bit for bit.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.utils.spans import span

# what the region mask adds between tokens of different regions
MASK_VALUE = -100.0
# the kernel's window and its largest head size (zero-padded to it)
KERNEL_WINDOW = 8
MAX_HEAD_DIM = 32
# heads a launch takes (the kernel's loop over them has no other limit)
MAX_HEADS = 16
# the span of each launch while a profiler runs, which counts its slices
LAUNCH_SPAN = "kernel.window_attention"


def serves(c: int, heads: int, window: int, shift: int,
           dtype: torch.dtype) -> bool:
    """Whether the kernel takes C = ``c`` channels in ``heads`` heads of
    windows ``window`` wide, shifted by ``shift``, in ``dtype``."""
    # a shift of 0 or 4 keeps a window row's two runs of 4 tokens whole
    if dtype != torch.bfloat16 or window != KERNEL_WINDOW or heads < 1 \
            or heads > MAX_HEADS or c % heads or shift not in (0, 4):
        return False
    hd = c // heads
    # 4-byte pairs of a head's channels, 8-byte output vectors, and the
    # window's q, k and v in the 227 KB of shared memory a block may use
    return hd % 2 == 0 and hd <= MAX_HEAD_DIM and c % 4 == 0 and \
        window * window * 3 * c * 2 <= 227 * 1024


@functools.lru_cache(maxsize=None)
def _relative_index_cpu(window: int) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    y, x = ys.reshape(-1), xs.reshape(-1)
    dy = y[:, None] - y[None, :] + window - 1
    dx = x[:, None] - x[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def relative_index(window: int, device=None) -> torch.Tensor:
    """(N, N) int64, N = window^2: the row of the bias table for query i
    and key j, (dy + w - 1)(2w - 1) + (dx + w - 1) with (dy, dx) = i's
    window coordinates minus j's (the published ``relative_position_index``)."""
    return _relative_index_cpu(window).to(device)


@functools.lru_cache(maxsize=32)
def _region_mask_cpu(h: int, w: int, window: int, shift: int
                     ) -> torch.Tensor:
    def regions(n):
        r = torch.zeros(n, dtype=torch.int64)
        r[n - window:] = 1
        r[n - shift:] = 2
        return r
    ids = regions(h)[:, None] * 3 + regions(w)[None, :]
    win = ids.view(h // window, window, w // window, window) \
        .permute(0, 2, 1, 3).reshape(-1, window * window)
    return torch.where(win[:, :, None] != win[:, None, :], MASK_VALUE, 0.0)


def region_mask(h: int, w: int, window: int, shift: int, device=None
                ) -> torch.Tensor:
    """(nW, N, N) fp32 over the windows of the frame rolled by -shift, in
    row-major window order: MASK_VALUE between tokens of different regions,
    0 within one. Per axis the regions are [0, L - window), [L - window,
    L - shift) and [L - shift, L), the tokens that the roll brought
    together from the frame's two ends."""
    return _region_mask_cpu(h, w, window, shift).to(device)


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` (B, H, W, ...) rolled by ``shift`` on both spatial axes."""
    return torch.roll(x, (shift, shift), (1, 2))


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           heads: int, window: int, shift: int
                           ) -> torch.Tensor:
    """The published sequence: roll by -shift, partition into windows,
    softmax(q k^T / sqrt(hd) + B + M) v by head in fp32 (the probabilities
    rounded to qkv's dtype before the product with v, as a bf16 matmul
    takes them), windows back, roll by +shift. qkv: (B, H, W, 3C), the
    last axis q | k | v each head-major; table: ((2w - 1)^2, heads) fp32.
    Returns (B, H, W, C) in qkv's dtype."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    n = window * window
    nh, nw = h // window, w // window
    if shift:
        qkv = _roll(qkv, -shift)
    t = qkv.reshape(b, nh, window, nw, window, 3, heads, hd) \
        .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nh * nw, heads, n, hd)
    q, k, v = t[0], t[1], t[2]
    s = (q.float() @ k.float().transpose(-2, -1)) * hd ** -0.5
    bias = table.float()[relative_index(window, qkv.device).view(-1)] \
        .view(n, n, heads).permute(2, 0, 1)
    s = s + bias
    if shift:
        s = s + region_mask(h, w, window, shift, qkv.device)[:, None]
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = (p @ v).reshape(b, nh, nw, heads, window, window, hd) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)
    if shift:
        o = _roll(o, shift)
    return o


def _check(qkv, table, heads, window, shift, c, out_width):
    if qkv.dim() != 4 or qkv.shape[-1] < 3 * c or out_width < c:
        raise ValueError(f"qkv must be (B, H, W, >= 3C) and the output's "
                         f"rows at least C = {c} wide, got "
                         f"{tuple(qkv.shape)} and {out_width}")
    _, h, w, _ = qkv.shape
    if h % window or w % window:
        raise ValueError(f"H and W must be multiples of the window "
                         f"{window}, got {h} x {w}")
    if not 0 <= shift < window:
        raise ValueError(f"shift must be in [0, {window}), got {shift}")
    if c % heads:
        raise ValueError(f"C = {c} is not a multiple of {heads} heads")
    if table.shape != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"table must be ({(2 * window - 1) ** 2}, {heads}), "
                         f"got {tuple(table.shape)}")


def _launch(qkv, table, heads, window, shift, c, out_width):
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if qkv.shape[-1] % 4 or out_width % 4:
        raise ValueError(f"qkv's and the output's rows must be multiples of "
                         f"4 channels, got {qkv.shape[-1]} and {out_width}")
    if table.dtype != torch.float32 or not table.is_contiguous() or \
            table.device != qkv.device:
        raise ValueError(f"table must be a contiguous float32 tensor on "
                         f"{qkv.device}")
    b, h, w, qs = qkv.shape
    out = torch.empty((b, h, w, out_width), dtype=qkv.dtype,
                      device=qkv.device)
    with span(LAUNCH_SPAN, count=b):
        code = _build.library().msr_window_attention(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, c,
            heads, shift, qs, out_width, _build.stream_ptr(qkv.device))
    window_attention.launches += 1
    _build.check(code, "window_attention")
    return out


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                     window: int, shift: int, dim: int = None,
                     out_width: int = None) -> torch.Tensor:
    """Shifted-window multi-head attention of the qkv linear's output
    ``qkv`` (B, H, W, 3C) with the relative-position bias ``table``; the
    (B, H, W, C) attention output at the tokens' own positions, before
    ``proj``. ``dim``: C, where qkv's rows are wider than 3C (their
    channels from 3C on are not read); ``out_width``: the output's rows,
    C by default, their channels from C on zero. The kernel where grad is
    off, on a CUDA tensor that :func:`serves` takes; elsewhere
    :func:`window_attention_plain`."""
    c = qkv.shape[-1] // 3 if dim is None else dim
    out_width = c if out_width is None else out_width
    _check(qkv, table, heads, window, shift, c, out_width)
    if qkv.is_cuda and not _build.needs_grad(qkv, table) and \
            serves(c, heads, window, shift, qkv.dtype):
        return _launch(qkv, table, heads, window, shift, c, out_width)
    o = window_attention_plain(qkv[..., :3 * c], table, heads, window, shift)
    return F.pad(o, (0, out_width - c)) if out_width > c else o


window_attention.launches = 0


def flops(b: int, h: int, w: int, c: int, window: int = KERNEL_WINDOW
          ) -> int:
    """Operations of one call: q k^T and P v, 2 N C multiply-adds a token
    each (N = window^2)."""
    return 4 * b * h * w * window * window * c


def bytes_moved(b: int, h: int, w: int, c: int, elem: int = 2) -> int:
    """Bytes one call must move: qkv read once (3C a token), the output
    written once (C)."""
    return b * h * w * 4 * c * elem

