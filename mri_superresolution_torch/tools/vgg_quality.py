"""Measured effect of the random-VGG19 perceptual term on trained quality,
on the card.

    python -m mri_superresolution_torch.tools.vgg_quality [--workdir DIR]
        [--epochs 30] [--n_train_volumes 6] [--n_test_volumes 2]
        [--n_slices 25] [--hr_size 128] [--seed 42] [--batch_size 8]
        [--models unet] [--skip_train] [--cpu]

The protocol of the JAX package's ``tools/vgg_quality.py``, with its flags
and defaults, run by the port alone. The reference's perceptual loss uses
ImageNet VGG19 features; without those weights ``--perceptual_weight > 0``
trains against a seeded random VGG19 (a structural prior, not a semantic
one; the trainer warns). This harness measures whether that term helps,
hurts or does nothing to held-out quality:

1. seeded train and test volumes and their extracted pairs
   (``tools/quality.py``'s steps; pairs already in ``--workdir`` are not
   made again);
2. each family of ``--models`` trained once a loss configuration:
   ``perc0`` (L1 0.7 + SSIM 0.3) and ``perc0.1`` (L1 0.6 + SSIM 0.3 + 0.1
   random-VGG19 perceptual); a family whose checkpoint exists is not
   trained again;
3. each best checkpoint served over the held-out pairs one image a call
   through ``load_engine`` in fp32, as the JAX tool's
   ``ours_infer_metrics`` serves.

The report is ``<workdir>/vgg_quality.json``: rows ``<family>_<config>``
of SSIM, PSNR, RMSE and MAE with their deltas against ``<family>_perc0``;
and the delta table on stdout. Everything runs on the card unless
``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict

from mri_superresolution_torch.tools import quality

CONFIGS = (("perc0", 0.0), ("perc0.1", 0.1))
DEFAULT_WORKDIR = Path(__file__).resolve().parents[2] / "build" / \
    "vgg_quality"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Quality effect of the "
                                 "random-VGG19 perceptual term")
    ap.add_argument("--workdir", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n_train_volumes", type=int, default=6)
    ap.add_argument("--n_test_volumes", type=int, default=2)
    ap.add_argument("--n_slices", type=int, default=25)
    ap.add_argument("--hr_size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--models", nargs="+", default=["unet"],
                    choices=quality.FAMILIES,
                    help="model families to compare")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the pairs and checkpoints in --workdir")
    ap.add_argument("--cpu", action="store_true",
                    help="run every step on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    """Run the protocol; returns the rows written to
    ``<workdir>/vgg_quality.json``."""
    from mri_superresolution_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    p = quality.workdir_paths(wd)

    if not args.skip_train:
        quality.ensure_pairs(p, args, wd, "vgg_quality")
        for mt in args.models:
            for name, pw in CONFIGS:
                ck = os.path.join(wd, f"ckpt_{mt}_{name}")
                if os.path.exists(os.path.join(ck, f"best_model_{mt}.ckpt")):
                    print(f"[vgg_quality] {mt}/{name}: checkpoint exists: "
                          f"skipping training (resume)", flush=True)
                    continue
                s = quality.run_train(quality.train_argv(
                    p, wd, mt, args, "--epochs", args.epochs,
                    "--perceptual_weight", pw, "--checkpoint_dir", ck),
                    os.path.join(wd, f"train_{mt}_{name}.jsonl"))
                print(f"[vgg_quality] trained {mt}/{name} in {s:.1f} s",
                      flush=True)

    pairs, lrs, hrs = quality.read_held_out(p)
    print(f"[vgg_quality] {len(pairs)} held-out pairs", flush=True)
    rows = {}
    for mt in args.models:
        base = f"{mt}_perc0"
        for name, _ in CONFIGS:
            m = quality.engine_row(
                os.path.join(wd, f"ckpt_{mt}_{name}", f"best_model_{mt}.ckpt"),
                mt, lrs, hrs, device, mode="fp32")
            rows[f"{mt}_{name}"] = quality.with_deltas(
                m, rows.get(base, m), base)
            print(f"{mt}/{name:<8} ssim={m['ssim']:.4f} "
                  f"psnr={m['psnr']:.3f} rmse={m['rmse']:.5f}", flush=True)

    print("\n| model | loss config | SSIM | PSNR (dB) | dSSIM | dPSNR (dB) |")
    print("|---|---|---|---|---|---|")
    for mt in args.models:
        for name, _ in CONFIGS:
            m = rows[f"{mt}_{name}"]
            print(f"| {mt} | {name} | {m['ssim']:.4f} | {m['psnr']:.3f} | "
                  f"{m['delta_ssim']:+.4f} | {m['delta_psnr']:+.3f} |")
    with open(os.path.join(wd, "vgg_quality.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
