"""How far the unet's fp32 gradients on the card sit from the CPU port's.

    python -m mri_superresolution_torch.tools.grad_gap [--base_filters 32]
        [--batch 2] [--lr 128]

One loss-and-gradient step (``train.trainer.loss_and_grads``, L1 + SSIM)
from seeded weights and a batch of phantoms, in fp32 with TF32 off, on the
CPU and then on the card in three ways: as the port runs it; with the
port's kernels (B1, B2, B3) swapped for their plain PyTorch versions; and
the same with cuDNN off. Prints one JSON line each: the loss's relative
difference, the largest relative L2 gradient difference (and its tensor),
the median over tensors, and the forward output's largest difference
over its range. If the plain and cuDNN-free runs sit as far from the CPU
as the port does, the gap is PyTorch's CUDA against its CPU ops, not the
port's kernels. The plain runs swap the functions the unet and the loss
call (module attributes) and put them back. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mri_superresolution_torch.config import LossConfig, ModelConfig
from mri_superresolution_torch.kernels import (conv3x3, group_norm_leaky,
                                               ssim_per_sample)
from mri_superresolution_torch.kernels.groupnorm import group_norm_leaky_plain
from mri_superresolution_torch.kernels.conv3x3 import conv3x3_plain
from mri_superresolution_torch.kernels.ssim import ssim_per_sample_plain
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.losses import combined
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import unet
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.phantom import phantom_batch


def _plain_gn(x, scale, bias, residual=None, n_groups=8, eps=1e-5):
    return group_norm_leaky_plain(x, scale, bias, residual, n_groups, 0.2,
                                  eps)


def _plain_ssim(a, b, *args):
    return ssim_per_sample_plain(a[..., 0], b[..., 0], *args)


def _use_plain(on: bool) -> None:
    unet.group_norm_leaky = _plain_gn if on else group_norm_leaky
    unet.conv3x3 = conv3x3_plain if on else conv3x3
    combined.ssim_per_sample = _plain_ssim if on else ssim_per_sample


def step(sd, cfg, lo, hr, device):
    m = build_model(cfg).to(device)
    m.load_state_dict(sd)
    loss, _, grads = trainer.loss_and_grads(
        m, CombinedLoss(LossConfig()), hr.to(device), lo.to(device),
        torch.ones(lo.shape[0], device=device))
    with torch.no_grad():
        out = m(lo.to(device)).cpu()
    return float(loss), [g.double().cpu() for g in grads], out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base_filters", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_gap: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(base_filters=args.base_filters)
    sd = build_model(cfg, generator=torch.Generator().manual_seed(3)
                     ).state_dict()
    lo = torch.from_numpy(phantom_batch(np.random.default_rng(3), args.batch,
                                        args.lr))[..., None]
    hr = torch.from_numpy(phantom_batch(np.random.default_rng(3), args.batch,
                                        2 * args.lr))[..., None]
    names = [n for n, _ in build_model(cfg).named_parameters()]
    lc, gc, oc = step(sd, cfg, lo, hr, "cpu")
    for label, plain, cudnn in (("port", False, True),
                                ("plain kernels", True, True),
                                ("plain kernels, no cuDNN", True, False)):
        _use_plain(plain)
        torch.backends.cudnn.enabled = cudnn
        lg, gg, og = step(sd, cfg, lo, hr, "cuda")
        rel = [float((a - b).norm() / b.norm()) for a, b in zip(gg, gc)]
        i = int(np.argmax(rel))
        print(json.dumps({
            "run": label, "base_filters": args.base_filters,
            "batch": args.batch, "lr": args.lr,
            "loss_rel_diff": abs(lg - lc) / abs(lc),
            "worst_tensor": names[i], "worst_rel_l2": rel[i],
            "median_rel_l2": float(np.median(rel)),
            "output_max_diff_over_range":
                float((og - oc).abs().max() / (oc.max() - oc.min())),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    _use_plain(False)
    torch.backends.cudnn.enabled = True


if __name__ == "__main__":
    main()
