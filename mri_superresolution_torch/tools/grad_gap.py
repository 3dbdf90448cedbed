"""How far the unet's fp32 gradients on the card sit from the CPU port's.

    python -m mri_superresolution_torch.tools.grad_gap [--base_filters 32]
        [--batch 2] [--lr 128] [--perceptual_weight 0.1]

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

With ``--perceptual_weight`` the loss takes the VGG19 term too (seeded
random VGG weights, fp32), and the gradients compared are the perceptual
term's alone (``d(w * perc)/d params``), beside the gradient with respect
to the unet's output and VGG's features of the output; the runs are then
the port as it runs, with ``cudnn.deterministic``, with cuDNN off, with
VGG in float64 on the card (against the CPU's float64 VGG), and with the
port's kernels swapped for their plain versions (with cuDNN on and off),
each also with VGG on the CPU's output (its cotangent carried back
through the card's unet), and a last line holds the CPU's own fp32
against float64 VGG.
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


def use_plain_kernels(on: bool) -> None:
    """Swap the port's kernels (B1, B2, B3) in the unet and the loss for
    their plain PyTorch versions (``on``), or put them back."""
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


class _VGG64(torch.nn.Module):
    """The same VGG19 run in float64: the features, and so the
    perceptual term, without fp32 rounding."""

    def __init__(self, vgg):
        super().__init__()
        self.vgg = vgg.double()

    def forward(self, x):
        return self.vgg(x.double(), torch.float64)


def perc_step(sd, cfg, lcfg, vgg_params, lo, hr, device, vgg64=False,
              shared_out=None):
    """The perceptual term's gradients (params, the unet's output) and
    VGG's features of the output, on ``device``; with ``shared_out`` (an
    output of another run) VGG takes that output, and its cotangent goes
    back through this run's unet."""
    from mri_superresolution_torch.models import vgg as vgg_mod
    m = build_model(cfg).to(device)
    m.load_state_dict(sd)
    vgg = vgg_mod.VGG19Features.from_params(
        vgg_params, lcfg.vgg_layer_idx).to(device)
    if vgg64:
        vgg = _VGG64(vgg)
    out = m(lo.to(device))
    x = out if shared_out is None else \
        shared_out.to(device).requires_grad_()
    total, comps = CombinedLoss(lcfg, vgg)(
        x, hr.to(device), torch.ones(lo.shape[0], device=device))
    perc = lcfg.perceptual_weight * comps["perceptual_loss"]
    g_out = torch.autograd.grad(perc, x)[0]
    grads = torch.autograd.grad(out, list(m.parameters()), g_out)
    with torch.no_grad():
        feats = vgg(x).double().cpu()
    return (float(perc.detach()), g_out.double().cpu(),
            [g.double().cpu() for g in grads], feats, out.detach().cpu())


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def perceptual_gap(sd, cfg, lo, hr, weight, names) -> None:
    from mri_superresolution_torch.models import vgg as vgg_mod
    lcfg = LossConfig(perceptual_weight=weight)
    vp = vgg_mod.random_params(torch.Generator().manual_seed(0),
                               lcfg.vgg_layer_idx)
    ref = perc_step(sd, cfg, lcfg, vp, lo, hr, "cpu")

    def report(label, got, device, against=None):
        ref_ = ref if against is None else against
        rel = [_rel(a, b) for a, b in zip(got[2], ref_[2])]
        i = int(np.argmax(rel))
        print(json.dumps({
            "run": label, "perceptual_weight": weight,
            "batch": lo.shape[0], "lr": lo.shape[1],
            "perc_rel_diff": abs(got[0] - ref_[0]) / abs(ref_[0]),
            "out_grad_rel_l2": _rel(got[1], ref_[1]),
            "features_rel_l2": _rel(got[3], ref_[3]),
            "worst_tensor": names[i], "worst_rel_l2": rel[i],
            "median_rel_l2": float(np.median(rel)), "device": device}),
            flush=True)

    ref64 = perc_step(sd, cfg, lcfg, vp, lo, hr, "cpu", True, ref[4])
    for label, det, cudnn, vgg64, plain in (
            ("port", False, True, False, False),
            ("cudnn.deterministic", True, True, False, False),
            ("no cuDNN", False, False, False, False),
            ("VGG in float64 on the card", False, True, True, False),
            ("plain kernels", False, True, False, True),
            ("plain kernels, no cuDNN", False, False, False, True)):
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.enabled = cudnn
        use_plain_kernels(plain)
        name = torch.cuda.get_device_name(0)
        report(label, perc_step(sd, cfg, lcfg, vp, lo, hr, "cuda", vgg64),
               name)
        report(label + ", on the CPU's output", perc_step(
            sd, cfg, lcfg, vp, lo, hr, "cuda", vgg64, ref[4]), name,
            ref64 if vgg64 else ref)
    use_plain_kernels(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.enabled = True
    report("CPU, VGG in float64", perc_step(sd, cfg, lcfg, vp, lo, hr,
                                           "cpu", True), "cpu")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base_filters", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=int, default=128)
    ap.add_argument("--perceptual_weight", type=float, default=0.0)
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
    if args.perceptual_weight > 0:
        perceptual_gap(sd, cfg, lo, hr, args.perceptual_weight, names)
        return
    lc, gc, oc = step(sd, cfg, lo, hr, "cpu")
    for label, plain, cudnn in (("port", False, True),
                                ("plain kernels", True, True),
                                ("plain kernels, no cuDNN", True, False)):
        use_plain_kernels(plain)
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
    use_plain_kernels(False)
    torch.backends.cudnn.enabled = True


if __name__ == "__main__":
    main()
