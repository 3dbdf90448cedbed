"""Where a call of B1's one-pass backward spends its time, phase by phase.

    python -m mri_superresolution_torch.tools.bwd_phases
        [--shapes 8x256x16x16 8x128x32x32 8x64x64x64 8x32x128x128 8x16x256x256]

``ncu`` does not run on the card's machine, so this looks inside the
kernel instead. It compiles ``csrc/groupnorm_bwd_onepass.cu`` with
``-DMSR_PHASE_MARKS`` into a library of its own under
``build/bwd_phases/``: thread 0 of each block then records ``clock64()``
at the end of each phase of its first two waves, and ``%globaltimer`` at
its start and end. The wrapper's one-pass route runs on that library (bf16,
seeded inputs, 3 calls) and the last call's marks are read back. Prints
one JSON line per (B, C, H, W): the plan, the clock rate, the spread of
the blocks' starts, the span from the first start to the last end, and per
wave and phase the median and the largest time over the blocks in µs.
A phase is thread 0's time from the previous mark, so a phase that ends in
``__syncthreads()`` includes the wait for the block's slowest warp. The
marks themselves (a store each) are included. Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from mri_superresolution_torch.kernels import _build, groupnorm

PHASES = ("x landed, sums", "statistics out", "exchange 1", "mean, rstd",
          "g landed, sums", "channel sums out", "exchange 2", "m1, m2",
          "dx", "counters, dgamma")
DEFAULT_SHAPES = ("8x256x16x16", "8x128x32x32", "8x64x64x64",
                  "8x32x128x128", "8x16x256x256")
_BLOCKS, _WAVES, _MARKS = 132, 2, 16


def marked_library() -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "bwd_phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"libmsr_bwd_phases_{_build.source_hash()}.so"
    if not lib.exists():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DMSR_PHASE_MARKS", "-shared", "-o", str(lib),
                        str(_build.CSRC / "groupnorm_bwd_onepass.cu"),
                        str(_build.CSRC / "common.cu")], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ("msr_gn_onepass_bwd_capacity", "msr_gn_onepass_bwd"):
        fn = getattr(dll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    dll.msr_error_string.argtypes = [ctypes.c_int]
    dll.msr_error_string.restype = ctypes.c_char_p
    dll.msr_phase_marks_read.argtypes = [ctypes.c_void_p]
    dll.msr_phase_marks_read.restype = ctypes.c_int
    return dll


def phases(dll, shape, dev) -> dict:
    b, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    xg = torch.randn((2 * b, h, w, c), generator=gen, device=dev).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    x, gy = xg[:b], xg[b:]
    gam = torch.randn(c, generator=gen, device=dev)
    bet = torch.randn(c, generator=gen, device=dev)
    plan = groupnorm.onepass_backward_plan(x, gy, torch.empty_like(x))
    if plan is None:
        raise ValueError(f"{shape} does not take the one-pass backward")
    for _ in range(3):
        groupnorm.group_norm_leaky_backward(x, gam, bet, gy)
    torch.cuda.synchronize()
    buf = np.zeros(_BLOCKS * _WAVES * _MARKS, dtype=np.uint64)
    _build.check(dll.msr_phase_marks_read(buf.ctypes.data), "phase marks")
    m = buf.reshape(_BLOCKS, _WAVES, _MARKS).astype(np.int64)[
        :plan.ranges * plan.images_per_wave]
    start_ns, end_ns = m[:, 0, 14], m[:, 0, 15]
    ghz = float(np.median((m[:, 0, 11] - m[:, 0, 0]) / (end_ns - start_ns)))
    res = {"shape": list(shape), "plan": plan._asdict(), "clock_ghz": ghz,
           "start_spread_us": float(start_ns.max() - start_ns.min()) / 1e3,
           "span_us": float(end_ns.max() - start_ns.min()) / 1e3}
    for wave in range(min(plan.waves, _WAVES)):
        marks = m[:, wave, :11].copy()
        if wave:
            marks[:, 0] = m[:, wave - 1, 10]
        # blocks with no image in this wave
        live = marks[:, 1] > marks[:, 0]
        d = np.diff(marks[live], axis=1) / ghz / 1e3
        res[f"wave{wave}"] = {
            name: [float(np.median(d[:, i])), float(d[:, i].max())]
            for i, name in enumerate(PHASES)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    dll = marked_library()
    groupnorm._bwd_capacity.cache_clear()
    with mock.patch.object(_build, "library", lambda: dll):
        for text in args.shapes:
            shape = tuple(int(v) for v in text.split("x"))
            print(json.dumps({"device": torch.cuda.get_device_name(0),
                              **phases(dll, shape, dev)}), flush=True)
    groupnorm._bwd_capacity.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
