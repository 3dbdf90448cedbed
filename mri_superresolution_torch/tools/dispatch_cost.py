"""Host cost of one call of a served kernel's wrapper, by route.

    python -m mri_superresolution_torch.tools.dispatch_cost [--calls 20000]

Times, on the CPU's plain version of kernel B1 (``group_norm_leaky`` at
(1, 8, 2, 2), under inference mode, so that the arithmetic is tiny and
the call's overhead dominates), the mean host µs a call of: the
implementation called directly (what the wrapper runs eagerly), the
dispatcher operator ``torch.ops.mri_sr.group_norm_leaky``
(``kernels/_ops.py``), and the same function registered as a
``torch.library.custom_op``. Prints one JSON line. A host measurement of
this machine's CPU, not of a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mri_superresolution_torch.kernels import groupnorm


def _us(fn, args, calls: int) -> float:
    for _ in range(calls // 10):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20000)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    @torch.library.custom_op("mri_sr_probe::group_norm_leaky",
                             mutates_args=())
    def custom(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               residual: torch.Tensor | None, n_groups: int,
               negative_slope: float, eps: float) -> torch.Tensor:
        return groupnorm._op_forward(x, scale, bias, residual, n_groups,
                                     negative_slope, eps)

    x = torch.randn(1, 8, 2, 2).contiguous(memory_format=torch.channels_last)
    call = (x, torch.ones(8), torch.zeros(8), None, 8, 0.2, 1e-5)
    with torch.inference_mode():
        res = {"direct_us": _us(groupnorm._op_forward, call, args.calls),
               "operator_us": _us(torch.ops.mri_sr.group_norm_leaky, call,
                                  args.calls),
               "custom_op_us": _us(custom, call, args.calls)}
    print(json.dumps({**res, "calls": args.calls, "device": "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
