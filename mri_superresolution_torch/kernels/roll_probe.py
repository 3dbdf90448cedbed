"""The lane-roll / 3-tap stencil probe: kernel B5 (three kernels).

Replaces the TPU kernels of ``tools/bench_roll_probe.py`` (``build`` over
the bodies ``copy_body``, ``roll32_body`` and ``taps3_body``). The CUDA
source is ``csrc/roll_probe.cu``; its note gives the semantics and what
bounds them on the H100 (bytes). The arrays are (R, L) bfloat16, processed
in 64-row blocks; the plain versions below define the results bit for bit,
each add rounded to bf16. The probe's entry point is
``mri_superresolution_torch.tools.roll_probe``.
"""

from __future__ import annotations

import torch

from mri_superresolution_torch.kernels import _build

ROW_BLOCK = 64
SHIFT = 32


def roll_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def roll32_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, SHIFT, 1)


def taps3_plain(x: torch.Tensor) -> torch.Tensor:
    r, lanes = x.shape
    xb = x.view(r // ROW_BLOCK, ROW_BLOCK, lanes)
    rolled = torch.roll(xb[:, 1:-1], SHIFT, 2)
    rolled[..., :SHIFT] = 0
    out = xb.clone()
    out[:, :-2] = (xb[:, :-2] + rolled) + xb[:, 2:]
    return out.view(r, lanes)


def _check(x, need_row_blocks):
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be a 2-D bfloat16 (rows, lanes) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    r, lanes = x.shape
    if lanes % 8 or lanes < SHIFT:
        raise ValueError(f"lanes must be a multiple of 8 and >= {SHIFT}, "
                         f"got {lanes}")
    if need_row_blocks and r % ROW_BLOCK:
        raise ValueError(f"rows must be a multiple of {ROW_BLOCK}, got {r}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _launch(wrapper, entry: str, plain, x: torch.Tensor,
            need_row_blocks: bool) -> torch.Tensor:
    _check(x, need_row_blocks)
    if x.device.type == "cpu":
        return plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    y = torch.empty_like(x)
    code = getattr(_build.library(), entry)(
        x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
        _build.stream_ptr(x.device))
    wrapper.launches += 1
    _build.check(code, wrapper.__name__)
    return y


def roll_copy(x: torch.Tensor) -> torch.Tensor:
    """``out = x`` (the probe's bandwidth baseline)."""
    return _launch(roll_copy, "msr_probe_copy", roll_copy_plain, x, False)


def roll32(x: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, 32, 1)``."""
    return _launch(roll32, "msr_probe_roll32", roll32_plain, x, False)


def taps3(x: torch.Tensor) -> torch.Tensor:
    """Per 64-row block: ``x[r] + mask(roll32(x[r+1])) + x[r+2]`` for the
    first 62 rows (lanes < 32 of the rolled tap zeroed), the last two
    rows copied."""
    return _launch(taps3, "msr_probe_taps3", taps3_plain, x, True)


roll_copy.launches = 0
roll32.launches = 0
taps3.launches = 0
