"""Measured EMA (``--ema_decay``) quality delta of trained models, on the
card.

    python -m mri_superresolution_torch.tools.ema_quality [--workdir DIR]
        [--epochs 30] [--decays 0.99] [--learning_rate 1e-4]
        [--n_train_volumes 6] [--n_test_volumes 2] [--n_slices 25]
        [--hr_size 128] [--seed 42] [--batch_size 8]
        [--models unet unet_tpu] [--no-augmentation] [--skip_train] [--cpu]

The protocol of the JAX package's ``tools/ema_quality.py``, with its flags
and defaults, run by the port alone (``tools/quality.py``'s steps:
synthetic-anatomy volumes, k-space-simulated pairs, training, held-out
pairs served one image a call through ``load_engine`` in bf16). Each
family trains once as a control (``--ema_decay 0``) and once a decay; EMA
never feeds back into training, so equal seeds give the same live
weights, and two comparisons share one optimizer trajectory:

1. best checkpoints, control against EMA (``<family>/best_control``,
   ``<family>/best_ema<d>``): what a user gets, with EMA-driven best-epoch
   selection;
2. the EMA run's final checkpoint, which serves the averaged weights
   (``<family>/final_ema<d>``) and carries the live ones as
   ``raw_params``, served again with those as its params
   (``<family>/finalraw_ema<d>``): averaging alone, without selection.

Pairs already in ``--workdir`` (a resumed run) are not made again. The
report is ``<workdir>/ema_quality.json`` (``decays``, ``lr``, ``epochs``,
``rows``: each row's SSIM, PSNR, RMSE and MAE, and its deltas against the
control's best row or against the raw final row), and the JAX tool's
markdown table on stdout. Everything runs on the card unless ``--cpu``.

``ema_recompute_gap`` holds the trainer's in-place EMA against a float64
recompute on the host from the live weights of each step.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from mri_superresolution_torch.tools import quality

DEFAULT_WORKDIR = Path(__file__).resolve().parents[2] / "build" / \
    "ema_quality"


def save_raw_as_params(final_ckpt: str, out_path: str) -> None:
    """Write an EMA checkpoint again at ``out_path`` (``.ckpt`` and its
    sidecar) with its live weights, ``raw_params``, as the served params
    and its meta. Raises ValueError when it carries none (EMA off)."""
    from mri_superresolution_torch.train import checkpoint as ckpt

    _, _, meta, extras = ckpt.load_checkpoint(final_ckpt, return_extras=True)
    if "raw_params" not in extras:
        raise ValueError(f"{final_ckpt} carries no raw_params extras (was "
                         f"it trained with --ema_decay > 0?)")
    ckpt.save_checkpoint(out_path, extras["raw_params"], meta=meta)


def ema_recompute_gap(device, dtype: torch.dtype, steps: int = 10,
                      batch: int = 8, lr_hw: int = 128,
                      decay: float = 0.9, base_filters: int = 32,
                      seed: int = 0) -> Dict:
    """The trainer's EMA against a float64 recompute on the host:
    ``steps`` train steps (``build_train_step`` with ``ema_decay=decay``,
    compute in ``dtype`` on fp32 params) of the unet at ``base_filters``
    on seeded phantom batches of ``batch`` x ``lr_hw``^2 -> (2 lr_hw)^2.
    After each step the live weights are copied to the host (after a
    synchronize: the next step overwrites them in place) and the average
    ``ema * d + params * (1 - d)`` is taken on them in float64, from the
    initial weights as the trainer starts it. Returns the largest gap of
    any tensor of ``state.ema`` to that recompute, relative to the
    recompute's largest magnitude in that tensor, and its name."""
    from mri_superresolution_torch.config import LossConfig, ModelConfig
    from mri_superresolution_torch.losses import CombinedLoss
    from mri_superresolution_torch.models import build_model
    from mri_superresolution_torch.train import trainer
    from mri_superresolution_torch.utils.phantom import phantom_batch

    device = torch.device(device)
    model = build_model(ModelConfig(base_filters=base_filters), dtype=dtype,
                        generator=torch.Generator().manual_seed(seed)
                        ).to(device)
    state = trainer.TrainState(
        model, trainer.make_optimizer(model.parameters(), 1e-4, 1e-5), 0,
        {k: p.detach().clone() for k, p in model.named_parameters()})
    step = trainer.build_train_step(CombinedLoss(LossConfig()),
                                    ema_decay=decay)
    host = {k: p.detach().to("cpu", torch.float64)
            for k, p in model.named_parameters()}
    for i in range(steps):
        rng = seed * 1000 + i
        b = {"lr": torch.from_numpy(phantom_batch(np.random.default_rng(
                 rng), batch, lr_hw)[..., None]).to(device),
             "hr": torch.from_numpy(phantom_batch(np.random.default_rng(
                 rng), batch, 2 * lr_hw)[..., None]).to(device),
             "weight": torch.ones(batch, device=device)}
        step(state, b, 1e-4)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for k, p in model.named_parameters():
            host[k] = host[k] * decay + p.detach().to(
                "cpu", torch.float64) * (1.0 - decay)
    gaps = {}
    for k, want in host.items():
        got = state.ema[k].detach().to("cpu", torch.float64)
        scale = float(want.abs().max())
        gaps[k] = float((got - want).abs().max()) / scale if scale else \
            float((got - want).abs().max())
    worst = max(gaps, key=gaps.get)
    return {"steps": steps, "decay": decay, "dtype": str(dtype),
            "tensors": len(gaps), "worst_tensor": worst,
            "worst_rel_gap": gaps[worst]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="EMA (--ema_decay) quality "
                                 "delta of trained models")
    ap.add_argument("--workdir", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--decays", type=float, nargs="+", default=[0.99],
                    help="EMA decays to measure (one training a decay; the "
                         "ema_decay=0 control is shared); match the horizon "
                         "~1/(1-d) steps to the run's length")
    ap.add_argument("--learning_rate", type=float, default=1e-4,
                    help="forwarded to the train CLI: EMA's value depends "
                         "on how noise- or trend-dominated the trajectory "
                         "is")
    ap.add_argument("--n_train_volumes", type=int, default=6)
    ap.add_argument("--n_test_volumes", type=int, default=2)
    ap.add_argument("--n_slices", type=int, default=25)
    ap.add_argument("--hr_size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the pairs and checkpoints in --workdir")
    ap.add_argument("--cpu", action="store_true",
                    help="run every step on the CPU")
    ap.add_argument("--augmentation", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--models", nargs="+", default=["unet", "unet_tpu"],
                    choices=quality.FAMILIES)
    return ap.parse_args(argv)


def table(rows: Dict, runs: Dict[str, float], models) -> str:
    """The JAX tool's markdown table: for each decay, best control -> EMA
    and the final raw -> EMA pair, with the deltas."""
    lines = ["| model | comparison | SSIM | PSNR (dB) | dSSIM | dPSNR (dB) |",
             "|---|---|---|---|---|---|"]
    for mt in models:
        for tag, d in runs.items():
            if d == 0:
                continue
            for k, name in ((f"{mt}/best_{tag}", f"best: control→ema d={d}"),
                            (f"{mt}/final_{tag}",
                             f"final d={d}: raw→ema (paired)")):
                m = rows[k]
                lines.append(f"| {mt} | {name} | {m['ssim']:.4f} | "
                             f"{m['psnr']:.3f} | {m['delta_ssim']:+.4f} | "
                             f"{m['delta_psnr']:+.3f} |")
    return "\n".join(lines)


def main(argv=None) -> Dict:
    """Run the protocol; returns the report written to
    ``<workdir>/ema_quality.json``."""
    from mri_superresolution_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    p = quality.workdir_paths(wd)
    runs = {"control": 0.0}
    runs.update({f"ema{d}": d for d in args.decays})

    if not args.skip_train:
        quality.ensure_pairs(p, args, wd, "ema_quality")
        for mt in args.models:
            for tag, decay in runs.items():
                s = quality.run_train(quality.train_argv(
                    p, wd, mt, args, "--epochs", args.epochs,
                    "--learning_rate", args.learning_rate,
                    "--ema_decay", decay,
                    *(["--augmentation"] if args.augmentation else []),
                    "--checkpoint_dir", os.path.join(wd, f"ckpt_{tag}")),
                    os.path.join(wd, f"train_{mt}_{tag}.jsonl"))
                print(f"[ema_quality] trained {mt}/{tag} in {s:.1f} s",
                      flush=True)

    pairs, lrs, hrs = quality.read_held_out(p)
    print(f"[ema_quality] {len(pairs)} held-out pairs", flush=True)
    rows = {}
    for mt in args.models:
        control = f"{mt}/best_control"
        rows[control] = quality.engine_row(
            os.path.join(wd, "ckpt_control", f"best_model_{mt}.ckpt"), mt,
            lrs, hrs, device)
        for tag, decay in runs.items():
            if decay == 0:
                continue
            ck = os.path.join(wd, f"ckpt_{tag}")
            best = quality.engine_row(
                os.path.join(ck, f"best_model_{mt}.ckpt"), mt, lrs, hrs,
                device)
            final = os.path.join(ck, f"final_model_{mt}.ckpt")
            raw = os.path.join(ck, f"rawfinal_model_{mt}")
            save_raw_as_params(final, raw)
            raw_row = quality.engine_row(raw + ".ckpt", mt, lrs, hrs,
                                         device)
            raw_name = f"{mt}/finalraw_{tag}"
            rows[f"{mt}/best_{tag}"] = quality.with_deltas(
                best, rows[control], control)
            rows[f"{mt}/final_{tag}"] = quality.with_deltas(
                quality.engine_row(final, mt, lrs, hrs, device), raw_row,
                raw_name)
            rows[raw_name] = quality.with_deltas(raw_row, raw_row, raw_name)
        rows[control] = quality.with_deltas(rows[control], rows[control],
                                            control)
        for k in sorted(k for k in rows if k.startswith(mt + "/")):
            m = rows[k]
            print(f"{k:<28} ssim={m['ssim']:.4f} psnr={m['psnr']:.3f} "
                  f"rmse={m['rmse']:.5f}", flush=True)

    print(f"\nlr={args.learning_rate} epochs={args.epochs}")
    print(table(rows, runs, args.models))
    report = {"decays": args.decays, "lr": args.learning_rate,
              "epochs": args.epochs, "rows": rows}
    with open(os.path.join(wd, "ema_quality.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
