"""Trained-model quality of the port, on the card: synthesize -> extract ->
train -> serve -> metrics.

    python -m mri_superresolution_torch.tools.quality [--workdir DIR]
        [--epochs 30] [--n_train_volumes 6] [--n_test_volumes 2]
        [--n_slices 25] [--hr_size 128] [--seed 42] [--batch_size 8]
        [--models unet unet_tpu edsr simple] [--no-augmentation]
        [--learning_rate 1e-4] [--patience 10]
        [--qat_decay 0.98] [--ft_epochs 8]
        [--skip_train] [--cpu]

The protocol of the JAX package's quality harnesses (``tools/
quality_parity.py``, ``tools/quant_quality.py``, ``tools/tta_quality.py``,
``tools/qat_quality.py``, ``tools/qat_ft_quality.py``), with their flags
and defaults, run by the port alone:
1. synthesize seeded BIDS volumes of structured anatomy (``make_volume``:
   ellipsoids and multi-scale texture, so that 2x SR is learnable), a train
   set and a held-out test set;
2. extract HR/LR pairs from both with the port's extract CLI (k-space LR
   simulation);
3. train each family in ``--models`` with the port's train CLI (augmented,
   as ``tta_quality.py`` trains, unless ``--no-augmentation``);
4. serve every held-out pair from each family's best checkpoint through
   ``load_engine``, one image a call as the JAX harness does: bf16, int8
   PTQ (calibrated on the first 8 content-rich train-split LR slices, so
   that every held-out pair is served by the frozen int8 path) and the
   dihedral TTA;
5. quantization-aware training: each family trained
   again with ``--qat`` from scratch (``qat_quality.py``), and its bf16
   run's final checkpoint fine-tuned with ``--qat --resume`` for
   ``--ft_epochs`` more epochs (``qat_ft_quality.py``); each best
   checkpoint served int8 with the sidecar it exported (no calibration
   forward) and bf16: rows ``qat-int8``, ``qat-bf16``, ``qat-ft-int8``,
   ``qat-ft-bf16``. The ``int8`` row is the JAX protocol's ``ptq-int8``;
6. the bilinear, sharp-bilinear and bicubic baselines on the same pairs;
7. ``metric_suites`` on each row's outputs (one launch of B2 a row), the
   means of SSIM, PSNR, RMSE and MAE, and each row's deltas against its
   family's bf16 row (the baselines' against the first family's); the
   same over the content pairs alone (``content_pairs``: an empty slice's
   black pair scores the baselines' 100 dB sentinel).

The report is ``<workdir>/quality.json``, and a markdown table on stdout.
Everything runs on the card unless ``--cpu``. The rows are guards of
quality, not gains. The port's other harnesses (``ema_quality``,
``vgg_quality``, ``edsr_convergence``) share steps 1-4 through
``ensure_pairs``, ``train_argv``, ``run_train`` and ``engine_row``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

FAMILIES = ("unet", "unet_tpu", "edsr", "simple")
MODES = ("bf16", "int8", "tta")
METRICS = ("ssim", "psnr", "rmse", "mae")
CALIB_SLICES = 8
DEFAULT_WORKDIR = Path(__file__).resolve().parents[2] / "build" / "quality"


def make_volume(rng: np.random.Generator,
                shape: Tuple[int, int, int] = (160, 160, 40)) -> np.ndarray:
    """A structured synthetic (H, W, D) 'anatomy' volume, values 0-780: a
    few smooth ellipsoids of distinct intensities plus band-limited
    texture at three scales (coarse noise upsampled by the port's
    cv2-parity bicubic ``resize``), so that 2x SR is learnable. The
    generator's draws are those of the JAX package's
    ``tools/quality_parity.make_volume``."""
    from mri_superresolution_torch.ops.resize import Interp, resize

    h, w, d = shape
    # the JAX harness's meshgrid, as broadcast axes: the same values
    zz = np.linspace(-1, 1, d)[:, None, None]
    yy = np.linspace(-1, 1, h)[None, :, None]
    xx = np.linspace(-1, 1, w)[None, None, :]
    vol = np.zeros((d, h, w), np.float32)
    for _ in range(rng.integers(4, 8)):
        c = rng.uniform(-0.5, 0.5, 3)
        r = rng.uniform(0.15, 0.55, 3)
        level = rng.uniform(0.25, 1.0)
        mask = (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
                + ((xx - c[2]) / r[2]) ** 2) < 1.0
        vol[mask] = level
    for scale, amp in ((8, 0.10), (24, 0.06), (64, 0.03)):
        coarse = rng.standard_normal((d, scale, scale)).astype(np.float32)
        tex = resize(torch.from_numpy(coarse), (h, w), Interp.CUBIC).numpy()
        vol = vol + amp * tex * (vol > 0)
    vol = np.clip(vol, 0, 1.3)
    return np.ascontiguousarray(vol.transpose(1, 2, 0)) * 600.0


def synthesize(root: str, n_volumes: int, seed: int) -> None:
    """``n_volumes`` float32 volumes as ``set1/sub-XX/anat/sub-XX_T1w.nii.gz``
    under ``root``."""
    from mri_superresolution_torch import nifti

    rng = np.random.default_rng(seed)
    for i in range(n_volumes):
        sub = os.path.join(root, f"set1/sub-{i:02d}/anat")
        os.makedirs(sub, exist_ok=True)
        nifti.save(os.path.join(sub, f"sub-{i:02d}_T1w.nii.gz"),
                   make_volume(rng).astype(np.float32))


def read_pngs(paths: Sequence[str]) -> np.ndarray:
    """Grayscale PNGs of one size as an (N, H, W) float32 [0, 1] stack."""
    from mri_superresolution_torch import native

    return np.stack([native.imread_gray(p) for p in paths]).astype(
        np.float32) / 255.0


def held_out_pairs(lr_dir: str, hr_dir: str) -> List[Tuple[str, str]]:
    """(LR, HR) paths of every LR file with an HR file of the same name."""
    return [(os.path.join(lr_dir, f), os.path.join(hr_dir, f))
            for f in sorted(os.listdir(lr_dir))
            if os.path.exists(os.path.join(hr_dir, f))]


def load_mode_engine(ckpt_path: str, model_type: str, mode: str, device,
                     calib_lrs: np.ndarray = (), scales_path: str = None):
    """The checkpoint's engine for ``mode`` (``MODES``, or ``fp32``: the
    fp32 model, a control of bf16's precision). int8 serves the
    scales frozen in ``scales_path`` if that file exists; otherwise it
    calibrates on ``calib_lrs`` in order, one image a call, until
    CALIB_SLICES of them were content-rich enough to count (the engine's
    foreground routing skips near-empty ones) and its scales freeze
    (written to ``scales_path`` if given), so that no held-out pair is
    served during calibration."""
    from mri_superresolution_torch.config import InferConfig, ModelConfig
    from mri_superresolution_torch.infer import load_engine

    engine = load_engine(InferConfig(
        model=ModelConfig(model_type=model_type),
        checkpoint_dir=os.path.dirname(ckpt_path),
        checkpoint_path=ckpt_path,
        bf16=mode != "fp32", quant="int8" if mode == "int8" else "none",
        quant_calib_slices=CALIB_SLICES,
        quant_calib_path=scales_path if mode == "int8" else None,
        tta=mode == "tta"), device=device)
    for lr in calib_lrs:
        if not engine.quant_calibrating:
            break
        engine.upscale_image(lr)
    if engine.quant_calibrating:
        raise RuntimeError(f"int8 calibration did not complete on "
                           f"{len(calib_lrs)} slices: "
                           f"{engine.quant_summary()}")
    return engine


def serve(engine, lrs: np.ndarray) -> np.ndarray:
    """Each LR image through the engine alone, as the JAX harness serves
    (the int8 foreground routing decides image by image)."""
    return np.stack([engine.upscale_image(lr) for lr in lrs])


def content_pairs(hrs: np.ndarray) -> np.ndarray:
    """(N,) True for each pair whose HR image is not constant. A black
    pair (an empty slice past the anatomy) has no content: its PSNR and
    SSIM measure only the output's offset from 0, and the interpolation
    baselines score the 100 dB sentinel on it."""
    flat = hrs.reshape(len(hrs), -1)
    return flat.max(axis=1) > flat.min(axis=1)


def summarize(outputs: np.ndarray, hrs: np.ndarray, device) -> Dict:
    """Means over the pairs of ``metric_suites`` (one B2 launch), the
    JAX protocol's row, and under ``content`` the means over the pairs
    that ``content_pairs`` keeps."""
    from mri_superresolution_torch.ops.metrics import metric_suites

    per = metric_suites(torch.from_numpy(np.ascontiguousarray(
        outputs, np.float32)).to(device), torch.from_numpy(hrs).to(device))
    keep = content_pairs(hrs)
    row = {k: float(np.mean([m[k] for m in per])) for k in METRICS}
    row["content"] = {k: float(np.mean([m[k] for m, c in zip(per, keep)
                                        if c])) for k in METRICS}
    return row


def with_deltas(row: Dict, base: Dict, base_name: str) -> Dict:
    """``row`` with its ``delta_<metric>`` against ``base``, over all
    pairs and over the content pairs."""
    out = dict(row)
    out.update({f"delta_{k}": row[k] - base[k] for k in METRICS})
    out["content"] = dict(row["content"])
    out["content"].update({f"delta_{k}": row["content"][k]
                           - base["content"][k] for k in METRICS})
    out["delta_vs"] = base_name
    return out


def checkpoint_rows(ckpt_path: str, model_type: str, lrs: np.ndarray,
                    hrs: np.ndarray, calib_lrs: np.ndarray, device,
                    scales_path: str = None) -> Tuple[Dict, Dict]:
    """Rows ``<family>/<mode>`` of one checkpoint served in every mode,
    with deltas against its bf16 row, and the outputs by mode. The int8
    row gives its calibration forwards and how many pairs were served
    int8 and bf16 (near-empty ones)."""
    rows, outs = {}, {}
    for mode in MODES:
        engine = load_mode_engine(ckpt_path, model_type, mode, device,
                                  calib_lrs, scales_path)
        before = dict(engine._quant_batches)
        outs[mode] = serve(engine, lrs)
        rows[f"{model_type}/{mode}"] = summarize(outs[mode], hrs, device)
        if mode == "int8":
            rows[f"{model_type}/{mode}"].update(
                calibration_forwards=sum(before.values()),
                served={k: v - before[k]
                        for k, v in engine._quant_batches.items()})
    base = f"{model_type}/bf16"
    return ({k: with_deltas(v, rows[base], base) for k, v in rows.items()},
            outs)


def qat_rows(ckpt_path: str, model_type: str, tag: str, lrs: np.ndarray,
             hrs: np.ndarray, device) -> Dict:
    """Rows ``<family>/<tag>-int8`` and ``<tag>-bf16`` of a QAT checkpoint:
    int8 with the scales of its sidecar (``calibration_forwards`` must be
    0) and bf16, without deltas yet."""
    rows = {}
    for mode in ("int8", "bf16"):
        engine = load_mode_engine(ckpt_path, model_type, mode, device)
        before = dict(engine._quant_batches)
        row = summarize(serve(engine, lrs), hrs, device)
        if mode == "int8":
            row.update(calibration_forwards=sum(before.values()),
                       served={k: v - before[k]
                               for k, v in engine._quant_batches.items()})
        rows[f"{model_type}/{tag}-{mode}"] = row
    return rows


def train_qat(p: Dict, wd: str, mt: str, args, common) -> Dict:
    """The two QAT runs of family ``mt``: --qat from scratch into
    ``ckpt_qat``, then the bf16 run's final checkpoint copied into
    ``ckpt_ft_<mt>`` and resumed with --qat for ``--ft_epochs`` epochs past
    the epochs it completed. Returns their seconds."""
    seconds = {}
    qat = ["--qat", "--qat_decay", str(args.qat_decay)]
    seconds[f"train_{mt}_qat"] = run_train(
        [*common, "--epochs", str(args.epochs), "--checkpoint_dir",
         p["ckpt_qat"], *qat], os.path.join(wd, f"train_{mt}_qat.jsonl"))
    base = os.path.join(p["ckpt"], f"final_model_{mt}")
    with open(base + ".json") as f:
        done = int(json.load(f)["epoch"]) + 1
    ft_dir = os.path.join(wd, f"ckpt_ft_{mt}")
    os.makedirs(ft_dir, exist_ok=True)
    for ext in (".ckpt", ".json"):
        shutil.copy(base + ext, os.path.join(ft_dir,
                                             f"final_model_{mt}{ext}"))
    seconds[f"train_{mt}_qat_ft"] = run_train(
        [*common, "--epochs", str(done + args.ft_epochs), "--checkpoint_dir",
         ft_dir, "--resume", *qat],
        os.path.join(wd, f"train_{mt}_qat_ft.jsonl"))
    return seconds


def baseline_rows(lrs: np.ndarray, hrs: np.ndarray, device, base: Dict,
                  base_name: str) -> Dict:
    """The three interpolation baselines on the pairs, with deltas
    against ``base``."""
    from mri_superresolution_torch.evalsuite.baselines import (
        INTERP_METHODS, upscale_with_interpolation)

    x = torch.from_numpy(lrs).to(device)
    rows = {}
    for method in INTERP_METHODS:
        up = upscale_with_interpolation(x, method).clamp(0.0, 1.0)
        rows[f"baseline/{method}"] = with_deltas(
            summarize(up.cpu().numpy(), hrs, device), base, base_name)
    return rows


def table(rows: Dict) -> str:
    """The rows as a markdown table: every pair, then the content pairs."""
    lines = ["| row | SSIM | PSNR (dB) | dSSIM | dPSNR (dB) | content SSIM "
             "| content PSNR (dB) | content dSSIM | content dPSNR (dB) | vs |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for name, m in rows.items():
        c = m["content"]
        lines.append(f"| {name} | {m['ssim']:.4f} | {m['psnr']:.3f} | "
                     f"{m['delta_ssim']:+.4f} | {m['delta_psnr']:+.3f} | "
                     f"{c['ssim']:.4f} | {c['psnr']:.3f} | "
                     f"{c['delta_ssim']:+.4f} | {c['delta_psnr']:+.3f} | "
                     f"{m['delta_vs']} |")
    return "\n".join(lines)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Trained-model quality of the "
                                 "port: bf16, int8 PTQ and TTA")
    ap.add_argument("--workdir", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n_train_volumes", type=int, default=6)
    ap.add_argument("--n_test_volumes", type=int, default=2)
    ap.add_argument("--n_slices", type=int, default=25,
                    help="slices per volume")
    ap.add_argument("--hr_size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the data and checkpoints in --workdir")
    ap.add_argument("--cpu", action="store_true",
                    help="run every step on the CPU")
    ap.add_argument("--augmentation", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="train with flip/rotate augmentation (TTA assumes "
                         "approximate flip-equivariance)")
    ap.add_argument("--models", nargs="+", default=list(FAMILIES),
                    choices=FAMILIES)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--patience", type=int, default=10,
                    help="early-stop patience (the LR plateau at "
                         "patience // 2)")
    ap.add_argument("--qat_decay", type=float, default=0.98)
    ap.add_argument("--ft_epochs", type=int, default=8,
                    help="epochs of the --qat --resume fine-tune past the "
                         "bf16 run's")
    return ap.parse_args(argv)


def workdir_paths(wd: str, *extra: str) -> Dict[str, str]:
    """The protocol's folders under ``wd``: the synthesized volumes, the
    extracted pairs of each split, and ``extra``."""
    return {k: os.path.join(wd, k) for k in
            ("data_train", "data_test", "hr_train", "lr_train", "hr_test",
             "lr_test", *extra)}


def ensure_pairs(p: Dict[str, str], args, wd: str, tag: str) -> None:
    """``make_pairs``, unless both splits' HR and LR folders already hold
    files (a resumed run, or pairs the caller put there)."""
    if all(os.path.isdir(p[k]) and os.listdir(p[k]) for k in
           ("hr_train", "lr_train", "hr_test", "lr_test")):
        print(f"[{tag}] pairs already extracted: skipping synthesis and "
              f"extraction", flush=True)
    else:
        print(f"[{tag}] synthesizing volumes", flush=True)
        make_pairs(p, args, wd)


def make_pairs(p: Dict[str, str], args, wd: str) -> Dict[str, float]:
    """Steps 1-2: seeded train and test volumes, then the extract CLI
    over each split (its output to ``<wd>/extract_<split>.log``); the
    seconds of each step."""
    from mri_superresolution_torch.cli import extract as extract_cli

    seconds = {}
    t0 = time.perf_counter()
    synthesize(p["data_train"], args.n_train_volumes, args.seed)
    synthesize(p["data_test"], args.n_test_volumes, args.seed + 1)
    seconds["synthesize"] = time.perf_counter() - t0
    for split in ("train", "test"):
        t0 = time.perf_counter()
        with open(os.path.join(wd, f"extract_{split}.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            rc = extract_cli.main([
                "--datasets_dir", p[f"data_{split}"],
                "--hr_output_dir", p[f"hr_{split}"],
                "--lr_output_dir", p[f"lr_{split}"],
                "--n_slices", str(args.n_slices),
                "--target_size", str(args.hr_size), str(args.hr_size),
                "--seed", str(args.seed),
                *(["--cpu"] if args.cpu else [])])
        if rc != 0:
            raise RuntimeError(f"extraction of the {split} split failed "
                               f"(see {wd}/extract_{split}.log)")
        seconds[f"extract_{split}"] = time.perf_counter() - t0
    return seconds


def train_argv(p: Dict[str, str], wd: str, mt: str, args, *flags
               ) -> List[str]:
    """The train CLI's flags of the protocol for family ``mt``: the train
    split's pairs, ``--batch_size``, SSIM weight 0.3, validation split
    0.2, ``--seed``, logs under ``wd``, ``--cpu`` if asked; then
    ``flags``."""
    return ["--full_res_dir", p["hr_train"], "--low_res_dir", p["lr_train"],
            "--batch_size", str(args.batch_size), "--ssim_weight", "0.3",
            "--validation_split", "0.2", "--seed", str(args.seed),
            "--model_type", mt, "--log_dir", os.path.join(wd, "logs"),
            *(["--cpu"] if args.cpu else []), *map(str, flags)]


def run_train(argv: Sequence[str], protocol_path: str) -> float:
    """``cli.train.main(argv)`` in this process, its JSON lines written to
    ``protocol_path``; the seconds it took."""
    from mri_superresolution_torch.cli import train as train_cli

    t0 = time.perf_counter()
    with open(protocol_path, "w") as f, contextlib.redirect_stdout(f):
        train_cli.main(list(argv))
    return time.perf_counter() - t0


def read_held_out(p: Dict[str, str]) -> Tuple[list, np.ndarray,
                                               np.ndarray]:
    """The test split's (LR, HR) pairs, and their LR and HR stacks."""
    pairs = held_out_pairs(p["lr_test"], p["hr_test"])
    return (pairs, read_pngs([a for a, _ in pairs]),
            read_pngs([b for _, b in pairs]))


def engine_row(ckpt_path: str, model_type: str, lrs: np.ndarray,
               hrs: np.ndarray, device, mode: str = "bf16") -> Dict:
    """One checkpoint served in ``mode`` (bf16, fp32 or tta) one image a
    call, and ``summarize``'s row: the JAX harnesses' ``engine_metrics``
    (bf16, tta) and ``ours_infer_metrics`` (fp32)."""
    return summarize(serve(load_mode_engine(ckpt_path, model_type, mode,
                                            device), lrs), hrs, device)


def main(argv=None) -> Dict:
    """Run the protocol; returns the report written to
    ``<workdir>/quality.json``."""
    from mri_superresolution_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    p = workdir_paths(wd, "ckpt", "ckpt_qat")
    seconds = {}

    if not args.skip_train:
        seconds.update(make_pairs(p, args, wd))
        for mt in args.models:
            print(f"[quality] training {mt}", flush=True)
            common = train_argv(
                p, wd, mt, args, "--learning_rate", args.learning_rate,
                "--patience", args.patience,
                *(["--augmentation"] if args.augmentation else []))
            seconds[f"train_{mt}"] = run_train(
                [*common, "--epochs", str(args.epochs),
                 "--checkpoint_dir", p["ckpt"]],
                os.path.join(wd, f"train_{mt}.jsonl"))
            print(f"[quality] training {mt} with --qat, and the --qat "
                  f"--resume fine-tune", flush=True)
            seconds.update(train_qat(p, wd, mt, args, common))

    pairs, lrs, hrs = read_held_out(p)
    calib = read_pngs([os.path.join(p["lr_train"], f) for f in
                       sorted(os.listdir(p["lr_train"]))])
    print(f"[quality] {len(pairs)} held-out pairs, LR {lrs.shape[1:]} -> "
          f"HR {hrs.shape[1:]}", flush=True)

    rows = {}
    t0 = time.perf_counter()
    for mt in args.models:
        ckpt_path = os.path.join(p["ckpt"], f"best_model_{mt}.ckpt")
        fam = checkpoint_rows(ckpt_path, mt, lrs, hrs, calib, device)[0]
        base = f"{mt}/bf16"
        for tag, d in (("qat", p["ckpt_qat"]),
                       ("qat-ft", os.path.join(wd, f"ckpt_ft_{mt}"))):
            fam.update({k: with_deltas(v, fam[base], base)
                        for k, v in qat_rows(
                            os.path.join(d, f"best_model_{mt}.ckpt"), mt,
                            tag, lrs, hrs, device).items()})
        rows.update(fam)
    base = f"{args.models[0]}/bf16"
    rows.update(baseline_rows(lrs, hrs, device, rows[base], base))
    seconds["serve_and_metrics"] = time.perf_counter() - t0

    report = {"config": vars(args), "device": (
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu"), "n_test_pairs": len(pairs),
        "n_content_pairs": int(content_pairs(hrs).sum()), "rows": rows,
        "seconds": seconds}
    with open(os.path.join(wd, "quality.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(table(rows))
    print(f"\nReport: {os.path.join(wd, 'quality.json')}")
    return report


if __name__ == "__main__":
    main()
