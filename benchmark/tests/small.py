"""Each cell at a size the CPU holds, for the tests: the same code and the
U-Net's published widths, the mix's sizes cut down (and EDSR's depth and
width)."""

import time

import torch

from benchmark import core

MAN = core.manifest()
# at a batch of 8 the first gradient's bf16 rounding reads a grad_diff of
# 0.04-0.08 on the CPU (half a batch 0.33-0.49, the control 0.25-0.39)
_LIMITS = core.config(MAN, "unet-parity-b32")[0]["limits"]
_SMALL_TRAIN = {"limits": dict(_LIMITS, train=dict(_LIMITS["train"],
                                                   grad_diff=0.15))}
SMALL = {
    "unet-volume-bf16": ({},
                         {"slices": 6, "height": 32, "width": 32, "pool": 2,
                          "batch_size": 4, "sample": 100000}),
    "edsr-volume-bf16": ({"base_filters": 16, "num_blocks": 2},
                         {"slices": 6, "height": 32, "width": 32, "pool": 2,
                          "batch_size": 4, "sample": 100000}),
    "unet-train-bf16": (_SMALL_TRAIN,
                        {"batch": 8, "lr_size": 32, "pool": 5, "warmup": 1}),
}


def run(workload, seed=2 ** 31 + 7, seconds=1.0, trace=False,
        system="program"):
    torch.manual_seed(0)
    cfg, mix = SMALL[workload]
    return core.run(workload, seed, seconds, trace, "cpu",
                    time.perf_counter(), system=system, man=MAN,
                    cfg_over=cfg, mix_over=mix)
