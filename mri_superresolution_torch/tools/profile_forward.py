"""Where a serving forward's device time goes, by kernel, on the GPU.

    python -m mri_superresolution_torch.tools.profile_forward \
        [--batch 16 --size 256 --base_filters 32] [--top 12]

Builds the unet with seeded random weights and a seeded phantom batch,
then for the bf16 engine and the int8 engine (frozen on that batch) times
``_dispatch_once`` (upload, forward, clamp, crop; no fetch) by the host
clock around a synchronize, and traces one more call with
``torch.profiler``. Prints one JSON line per engine: the host ms per
forward, the device kernel ms the trace saw, and the top kernels by
device time and host ops by self CPU time with their counts
(``tools/profile_step.py``'s ``trace_calls``, which traces a training
step the same way).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer import InferenceEngine
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.tools.profile_step import trace_calls
from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.phantom import phantom_batch


def profile_engine(engine: InferenceEngine, batch: np.ndarray, top: int = 12,
                   iters: int = 10) -> dict:
    return trace_calls(lambda: engine._dispatch_once(batch), top, iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--base_filters", type=int, default=32)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    cfg = ModelConfig(base_filters=args.base_filters)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    batch = phantom_batch(np.random.default_rng(0), args.batch, args.size)
    engines = {
        "bf16": InferenceEngine(cfg, params, device=dev),
        "int8": InferenceEngine(cfg, params, device=dev, quant="int8",
                                quant_calib_slices=args.batch),
    }
    engines["int8"].upscale_batch(batch)            # calibrate and freeze
    for name, eng in engines.items():
        print(json.dumps({"engine": name, "batch": args.batch,
                          "size": args.size,
                          "device": torch.cuda.get_device_name(0),
                          **profile_engine(eng, batch, args.top)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
