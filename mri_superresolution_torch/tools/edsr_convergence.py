"""Train a family (``edsr`` by default) to its convergence plateau and
report its held-out rows, on the card.

    python -m mri_superresolution_torch.tools.edsr_convergence
        [--workdir DIR] [--epochs 300] [--patience 40]
        [--learning_rate 1e-4] [--n_train_volumes 6] [--n_test_volumes 2]
        [--n_slices 25] [--hr_size 128] [--seed 42] [--batch_size 8]
        [--model_type edsr] [--skip_train] [--cpu]

The protocol of the JAX package's ``tools/edsr_convergence.py``, with its
flags and defaults, run by the port alone: ``tools/quality.py``'s
synthetic-anatomy pairs (pairs already in ``--workdir`` are not made
again), one augmented training with a large epoch budget and a patience
wide enough that the LR plateau (factor 0.5 at ``patience // 2`` stagnant
epochs) fires several times before early stopping ends the run, then the
best checkpoint served over the held-out pairs one image a call through
``load_engine`` in bf16, plain and with the dihedral TTA.

The report is ``<workdir>/<model_type>_convergence.json``: rows
``<model_type>/plain`` and ``<model_type>/tta`` (SSIM, PSNR, RMSE, MAE,
with deltas against the plain row), and a ``protocol`` block (epochs,
patience, learning rate, HR size, seed). Everything runs on the card
unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict

from mri_superresolution_torch.tools import quality

DEFAULT_WORKDIR = Path(__file__).resolve().parents[2] / "build" / \
    "edsr_convergence"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train a family to its "
                                 "convergence plateau")
    ap.add_argument("--workdir", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--patience", type=int, default=40,
                    help="early-stop patience; the LR plateau fires at "
                         "patience // 2 stagnant epochs, so 40 allows "
                         "several halvings before the run ends")
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--n_train_volumes", type=int, default=6)
    ap.add_argument("--n_test_volumes", type=int, default=2)
    ap.add_argument("--n_slices", type=int, default=25)
    ap.add_argument("--hr_size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the pairs and checkpoint in --workdir")
    ap.add_argument("--cpu", action="store_true",
                    help="run every step on the CPU")
    ap.add_argument("--model_type", default="edsr", choices=quality.FAMILIES)
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    """Run the protocol; returns the report written to
    ``<workdir>/<model_type>_convergence.json``."""
    from mri_superresolution_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    p = quality.workdir_paths(wd, "ckpt")
    mt = args.model_type

    if not args.skip_train:
        quality.ensure_pairs(p, args, wd, "edsr_convergence")
        s = quality.run_train(quality.train_argv(
            p, wd, mt, args, "--epochs", args.epochs, "--learning_rate",
            args.learning_rate, "--patience", args.patience,
            "--augmentation", "--checkpoint_dir", p["ckpt"]),
            os.path.join(wd, f"train_{mt}.jsonl"))
        print(f"[edsr_convergence] trained {mt} in {s:.1f} s", flush=True)

    pairs, lrs, hrs = quality.read_held_out(p)
    print(f"[edsr_convergence] {len(pairs)} held-out pairs", flush=True)
    ckpt = os.path.join(p["ckpt"], f"best_model_{mt}.ckpt")
    rows = {}
    for mode, name in (("bf16", "plain"), ("tta", "tta")):
        m = quality.engine_row(ckpt, mt, lrs, hrs, device, mode=mode)
        base = rows.get(f"{mt}/plain", m)
        rows[f"{mt}/{name}"] = quality.with_deltas(m, base, f"{mt}/plain")
        print(f"{mt:<10} {name:<6} ssim={m['ssim']:.4f} psnr={m['psnr']:.3f} "
              f"rmse={m['rmse']:.5f}", flush=True)
    rows["protocol"] = {"epochs": args.epochs, "patience": args.patience,
                        "learning_rate": args.learning_rate,
                        "hr_size": args.hr_size, "seed": args.seed}
    with open(os.path.join(wd, f"{mt}_convergence.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
