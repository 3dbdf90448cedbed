"""The lane-roll / 3-tap stencil probe (kernel B5) on the GPU.

    python -m mri_superresolution_torch.tools.roll_probe \
        [--rows 512 --lanes 16384] [--cpu]

Makes a seeded standard-normal (rows, lanes) bf16 array, checks each of the
three kernels (``copy``, ``roll32``, ``taps3``; ``kernels/roll_probe.py``)
against its plain version (exact), then prints each kernel's device time
per call and its rate over one read and one write of the array, beside
``x.clone()`` and ``torch.roll`` as library baselines. Those times are
the device's, L2-cold (``utils.timing.cuda_ms_cold``): the calls take in
turn copies of the array that together hold more than twice the card's
L2, each writes an output of its own, and they are replayed from a CUDA
graph, so each call reads and writes device memory as the bound assumes
and the wrapper's host overhead is not counted. ``call_us`` is each
kernel's time through its wrapper, called from Python in a loop
(``cuda_ms``, L2-warm): the gap to ``us`` is the host's share. The default
shape is the TPU probe's: 512 rows of 512 positions x 32 channels.
``--cpu`` checks the plain versions on the CPU and times nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mri_superresolution_torch.kernels.roll_probe import (
    roll32, roll32_plain, roll_copy, roll_copy_plain, taps3, taps3_plain)
from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.timing import (cuda_ms, cuda_ms_cold,
                                                    l2_cold_copies)

ITERS = 50          # timed calls per measurement
# name -> (wrapper, plain version, library call or None)
PROBES = {
    "copy": (roll_copy, roll_copy_plain, lambda x: x.clone()),
    "roll32": (roll32, roll32_plain, lambda x: torch.roll(x, 32, 1)),
    "taps3": (taps3, taps3_plain, None),
}


def run(rows: int = 512, lanes: int = 16384, device=None) -> dict:
    """Check and time the three kernels; returns {name: result}. On the
    CPU (``device="cpu"``) the wrappers run their plain versions and
    nothing is timed. Raises if a kernel disagrees with its plain
    version."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (rows, lanes)).astype(np.float32)).to(torch.bfloat16).to(dev)
    nbytes = 2 * x.numel() * x.element_size()        # one read, one write
    xs = l2_cold_copies(x) if dev.type == "cuda" else None
    out = {}
    for name, (fn, plain, lib) in PROBES.items():
        exact = torch.equal(fn(x), plain(x))
        if not exact:
            raise AssertionError(f"{name} disagrees with its plain version")
        res = {"exact": exact}
        if dev.type == "cuda":
            # ten warm-up calls each: the card may come from idle clocks
            ms = cuda_ms_cold(fn, xs, ITERS, warmup=10)
            res.update(us=ms * 1e3, gb_s=nbytes / ms / 1e6,
                       call_us=cuda_ms(lambda: fn(x), ITERS, 10) * 1e3,
                       plain_us=cuda_ms_cold(plain, xs, ITERS, 10) * 1e3)
            lib_ms = cuda_ms_cold(lib, xs, ITERS, 10) if lib else None
            res.update(library_us=None if lib_ms is None else lib_ms * 1e3,
                       library_gb_s=None if lib_ms is None
                       else nbytes / lib_ms / 1e6)
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--lanes", type=int, default=16384)
    ap.add_argument("--cpu", action="store_true",
                    help="check the plain versions on the CPU; no timing")
    args = ap.parse_args(argv)
    res = run(args.rows, args.lanes, "cpu" if args.cpu else None)
    for name, r in res.items():
        if "us" in r:
            lib = ("" if r["library_us"] is None else
                   f"  library {r['library_us']:9.2f} us/call "
                   f"{r['library_gb_s']:8.1f} GB/s")
            print(f"{name:7s} {r['us']:9.2f} us/call {r['gb_s']:8.1f} GB/s"
                  f"  via wrapper {r['call_us']:9.2f} us/call"
                  f"  plain {r['plain_us']:9.2f} us/call{lib}")
    print(json.dumps({"rows": args.rows, "lanes": args.lanes,
                      "device": "cpu" if args.cpu
                      else torch.cuda.get_device_name(0), "probes": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
