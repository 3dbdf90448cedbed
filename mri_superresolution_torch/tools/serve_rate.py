"""Eager serving slices/s of ``InferenceEngine.upscale_batch`` on the GPU.

    python mri_superresolution_torch/tools/serve_rate.py [--tree DIR]
        [--batch 16 --size 256 --base_filters 32] [--rounds 5 --iters 20]

Imports ``mri_superresolution_torch`` from DIR (default: the checkout this
file sits in), so that an older commit unpacked in DIR is measured by
this script beside the current one in one call (run them in turns:
older, newer, newer, older). Builds the unet engine in bf16 with seeded
random weights and a seeded phantom batch of ``batch`` slices of
``size``^2, serves 3 batches to warm up, then ``rounds`` rounds of
``iters`` batches, each ended by the host fetch. Prints one JSON line:
slices/s of each round, their median, and the card's name.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--base_filters", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from mri_superresolution_torch.config import ModelConfig
    from mri_superresolution_torch.infer.engine import InferenceEngine
    from mri_superresolution_torch.models import build_model
    from mri_superresolution_torch.utils.phantom import phantom_batch
    if not torch.cuda.is_available():
        print("serve_rate: no CUDA device", file=sys.stderr)
        return 1
    cfg = ModelConfig(base_filters=args.base_filters)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    engine = InferenceEngine(cfg, params, device="cuda")
    batch = phantom_batch(np.random.default_rng(0), args.batch, args.size)
    for _ in range(3):
        engine.upscale_batch(batch)
    rates = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            engine.upscale_batch(batch)
        rates.append(args.batch * args.iters / (time.perf_counter() - t0))
    print(json.dumps({"tree": tree, "batch": args.batch, "size": args.size,
                      "base_filters": args.base_filters, "dtype": "bf16",
                      "slices_per_s": rates,
                      "median_slices_per_s": statistics.median(rates),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
