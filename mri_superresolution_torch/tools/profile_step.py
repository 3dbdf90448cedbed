"""Where a bf16 training step's time goes, by kernel and by host op, on the GPU.

    python mri_superresolution_torch/tools/profile_step.py [--tree DIR]
        [--batch 8 --size 128 --base_filters 32] [--top 12]
        [--perceptual_weight 0.1 [--no_tf32]]

Imports ``mri_superresolution_torch`` from DIR (default: the checkout this
file sits in), so that an older commit unpacked in DIR is traced by this
script beside the current one in the same call. Builds the unet (bf16
compute on fp32 master weights, seeded random weights), Adam and the
L1 + SSIM loss at the JAX package's defaults (with ``--perceptual_weight``
also the VGG19 perceptual term on seeded random VGG weights, its fp32
convs in TF32 unless ``--no_tf32``), and a seeded phantom batch
of ``batch`` slices of ``size``^2 -> (2 size)^2 on the card (augmentation
off); times 10 steps by the host clock around a synchronize, after 3
warm-up steps, and traces one more step with ``torch.profiler``. Prints
one JSON line: the host ms a step, the device kernel ms the trace saw,
the launches, the top kernels by device time with their launch counts,
and the top host ops by self CPU time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def trace_calls(fn, top: int = 12, iters: int = 10, warmup: int = 2) -> dict:
    """Host ms a call of ``fn`` (the mean of ``iters`` calls after
    ``warmup``, synchronized), then one more call traced with
    ``torch.profiler``: device kernel ms, launches, and the top kernels by
    device time and host ops by self CPU time, with their counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side ranges of user annotations (Optimizer.step#Adam.step)
    # carry a CPU range's name and span kernels counted on their own
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and not getattr(e, "is_user_annotation", False)
                      and e.key not in host_keys),
                     key=lambda r: -r[1])
    host_ops = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in events if e.device_type == DeviceType.CPU),
                      key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    return {"host_ms": host_ms, "device_ms": device_ms,
            "launches": sum(n for _, _, n in kernels),
            "top": [{"kernel": k[:120], "ms": ms, "count": n,
                     "share": ms / device_ms}
                    for k, ms, n in kernels[:top]],
            "top_host": [{"op": k[:120], "self_ms": ms, "count": n}
                         for k, ms, n in host_ops[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--base_filters", type=int, default=32)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--perceptual_weight", type=float, default=0.0)
    ap.add_argument("--no_tf32", action="store_true",
                    help="cuDNN's fp32 convs (VGG's) in full fp32")
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from mri_superresolution_torch.config import LossConfig, ModelConfig
    from mri_superresolution_torch.losses import CombinedLoss
    from mri_superresolution_torch.models import build_model
    from mri_superresolution_torch.train import trainer
    from mri_superresolution_torch.utils.phantom import phantom_batch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    model = build_model(ModelConfig(base_filters=args.base_filters),
                        dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    state = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), 1e-4, 1e-5))
    lcfg = LossConfig(perceptual_weight=args.perceptual_weight)
    vgg = None
    if lcfg.perceptual_weight > 0:
        from mri_superresolution_torch.models import vgg as vgg_mod
        vgg = vgg_mod.VGG19Features.from_params(
            vgg_mod.random_params(torch.Generator().manual_seed(0),
                                  lcfg.vgg_layer_idx),
            lcfg.vgg_layer_idx).to(dev)
    torch.backends.cudnn.allow_tf32 = not args.no_tf32
    step = trainer.build_train_step(CombinedLoss(lcfg, vgg))
    batch = {"lr": torch.from_numpy(phantom_batch(
                 np.random.default_rng(2), args.batch,
                 args.size)[..., None]).to(dev),
             "hr": torch.from_numpy(phantom_batch(
                 np.random.default_rng(2), args.batch,
                 2 * args.size)[..., None]).to(dev),
             "weight": torch.ones(args.batch, device=dev)}
    res = trace_calls(lambda: step(state, batch, 1e-4), args.top,
                      warmup=3)
    print(json.dumps({"tree": tree, "batch": args.batch, "size": args.size,
                      "base_filters": args.base_filters,
                      "perceptual_weight": args.perceptual_weight,
                      "tf32": torch.backends.cudnn.allow_tf32,
                      "device": torch.cuda.get_device_name(0), **res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
