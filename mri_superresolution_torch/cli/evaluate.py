"""Benchmark and ablation runs: the time and the quality of each method
per image.

    python -m mri_superresolution_torch.cli.evaluate --hr_dir hr \
        --lr_dir lr --checkpoint ckpt/best_model_unet.ckpt \
        [--output_dir ./eval_results] [--quant int8] [--tta] [--cpu]
    python -m mri_superresolution_torch.cli.evaluate --hr_dir hr \
        --lr_dir lr --ablation_checkpoints_dir ckpts/
    python -m mri_superresolution_torch.cli.evaluate --hr_dir hr \
        --lr_dir lr --ablation_train_configs configs.json \
        --train_full_res_dir train_hr --train_low_res_dir train_lr

Takes the flags of the JAX package's ``evaluate.py`` (reference
evaluate.py:131-364), with the same defaults and meanings, and writes the
same files: a hardware report, dataset statistics with a resolution
histogram, the implementation details of each checkpoint (from its JSON
sidecar), the per-image time and quality of bicubic, bilinear,
sharp-bilinear and the model (``metrics.csv``, the JAX run's columns in
its order), qualitative figures of the first 5 pairs, and ``report.json``;
in the two ablation modes, ``metrics_ablation.csv`` and
``ablation_summary.json`` (and ``report_base.json`` for a directory of
``.ckpt``/``.pth`` checkpoints). ``--ablation_train_configs`` trains each
loss configuration with ``python -m mri_superresolution_torch.cli.train``
in a process of its own, on the card unless ``--cpu`` is given, into
``./ablation_checkpoints/<name>``, then evaluates it.

Runs on the card; ``--cpu`` (or ``--device cpu``) runs on the CPU. Each
method's time ends when its output is on the host. The five metrics of
the four methods of a pair take one ``metric_suites`` call: one launch of
kernel B2 on the card. Figures need matplotlib; without it they are
skipped with a warning, and nothing else changes.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

BASELINES = ("bicubic", "bilinear", "sharp_bilinear")
MODEL_METHOD = "unet"


def _nvidia_smi(index: int) -> str | None:
    """``nvidia-smi``'s name and power limit of card ``index``, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def report_hardware(device=None):
    """The host and the device the evaluation runs on: CPU, cores, RAM
    (``os.sysconf``), and the card's name from ``torch.cuda`` with its
    power limit from ``nvidia-smi``."""
    import torch

    from mri_superresolution_torch.utils.device import resolve_device

    dev = resolve_device(device)
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    info = {
        "cpu": platform.processor() or platform.machine(),
        "cpu_count": os.cpu_count(),
        "ram_gb": round(ram / 1e9, 2),
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        smi = _nvidia_smi(index)
        info.update(accelerator=torch.cuda.get_device_name(index),
                    n_devices=torch.cuda.device_count(), backend="cuda",
                    nvidia_smi=smi,
                    power_limit=smi.split(",")[-1].strip() if smi else None)
    else:
        info.update(accelerator="cpu", n_devices=1, backend="cpu")
    print("Hardware Info:", info)
    return info


def report_dataset_stats(hr_dir, lr_dir, output_dir):
    """Pairs, subjects and the HR resolution histogram (its path, or None
    where the figure was skipped)."""
    from mri_superresolution_torch import native
    from mri_superresolution_torch.data import PairedSliceDataset
    from mri_superresolution_torch.evalsuite.resolution import (
        analyze_resolutions, visualize_resolution_histogram)

    dataset = PairedSliceDataset(hr_dir, lr_dir)
    subjects = dataset.get_unique_subjects()
    print(f"Test images: {len(dataset)}, Subjects: {len(subjects)}")
    resolutions = []
    for meta in dataset.metadata:
        hw = native.png_size(meta["full_res_path"])
        if hw is None:
            hw = native.imread_gray(meta["full_res_path"]).shape
        resolutions.append((int(hw[1]), int(hw[0])))
    hist_path = os.path.join(output_dir, "resolution_histogram.png")
    written = visualize_resolution_histogram(
        analyze_resolutions(resolutions), hist_path)
    return {"n_images": len(dataset), "subjects": subjects,
            "resolution_histogram": hist_path if written else None}


def report_implementation_details(checkpoint_path):
    """Training hyperparameters and validation results from a
    checkpoint's JSON sidecar."""
    params = {}
    base = str(checkpoint_path)
    for suffix in (".ckpt", ".pth", ".msgpack"):
        if base.endswith(suffix):
            base = base[:-len(suffix)]
    sidecar = base + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        cfg = meta.get("config", {})
        for k in ("epochs", "batch_size", "learning_rate", "weight_decay"):
            if k in cfg:
                params[k] = cfg[k]
        for k in ("ssim_weight", "perceptual_weight"):
            if k in cfg.get("loss", {}):
                params[k] = cfg["loss"][k]
        if "base_filters" in cfg.get("model", {}):
            params["base_filters"] = cfg["model"]["base_filters"]
        for k in ("val_loss", "val_ssim", "epoch"):
            if k in meta:
                params[k] = meta[k]
    print("Implementation details:", params)
    return params


def _read(path):
    from mri_superresolution_torch import native
    return native.imread_gray(str(path))


def _lr_shape(path):
    from mri_superresolution_torch import native
    hw = native.png_size(str(path))
    return tuple(hw) if hw is not None else _read(path).shape


def run_benchmarks(test_pairs, engine):
    """Per-image time and quality of every method, one row a method and
    image: ``ssim``, ``psnr``, ``mse``, ``rmse``, ``mae``, ``method``,
    ``time`` (seconds, ending when the output is on the host) and
    ``image`` (parity: evaluate.py:62-108). Each input shape is run once
    through every method before any timing."""
    import numpy as np
    import torch

    from mri_superresolution_torch.cli.test_comparison import method_metrics
    from mri_superresolution_torch.evalsuite.baselines import (
        upscale_with_interpolation)
    from mri_superresolution_torch.infer import preprocess_image_array

    dev = engine.device

    def baseline(img01, method):
        return upscale_with_interpolation(torch.from_numpy(img01).to(dev),
                                          method).cpu().numpy()

    results = []
    if test_pairs:
        shapes = {}
        for lr_path, _ in test_pairs:
            hw = _lr_shape(lr_path)
            if hw not in shapes:
                shapes[hw] = _read(lr_path)
        print(f"Warming up {len(shapes)} distinct input shape(s) x "
              f"{len(BASELINES) + 1} methods (first calls excluded from "
              f"timings)")
        for warm in shapes.values():
            for method in BASELINES:
                baseline(warm.astype(np.float32) / 255.0, method)
            engine.upscale_image(preprocess_image_array(
                warm.astype(np.float32)))
    for lr_path, hr_path in test_pairs:
        hr_img = preprocess_image_array(_read(hr_path).astype(np.float32))
        lr_raw = _read(lr_path)
        lr_img01 = lr_raw.astype(np.float32) / 255.0
        lr_norm = preprocess_image_array(lr_raw.astype(np.float32))

        outputs, times = {}, {}
        for method in BASELINES:
            t0 = time.perf_counter()
            outputs[method] = baseline(lr_img01, method)
            times[method] = time.perf_counter() - t0
        t0 = time.perf_counter()
        outputs[MODEL_METHOD] = engine.upscale_image(lr_norm)
        times[MODEL_METHOD] = time.perf_counter() - t0

        metrics = method_metrics(outputs, hr_img, dev)
        for method in outputs:
            results.append(dict(metrics[method], method=method,
                                time=times[method],
                                image=os.path.basename(str(lr_path))))
    return results


def qualitative_comparison(test_pairs, engine, output_dir):
    """Figures of bicubic and the model on the first 5 pairs (parity:
    evaluate.py:110-129)."""
    import numpy as np
    import torch

    from mri_superresolution_torch.cli.test_comparison import (
        method_metrics, visualize_results)
    from mri_superresolution_torch.evalsuite.baselines import (
        upscale_with_interpolation)
    from mri_superresolution_torch.infer import preprocess_image_array
    from mri_superresolution_torch.utils.logging import setup_logging

    dev = engine.device
    logger = setup_logging("evaluate.log")
    os.makedirs(output_dir, exist_ok=True)
    for i, (lr_path, hr_path) in enumerate(test_pairs[:5]):
        hr_img = preprocess_image_array(_read(hr_path).astype(np.float32))
        lr_raw = _read(lr_path)
        lr_img01 = lr_raw.astype(np.float32) / 255.0
        bicubic = upscale_with_interpolation(
            torch.from_numpy(lr_img01).to(dev), "bicubic").cpu().numpy()
        sr = engine.upscale_image(
            preprocess_image_array(lr_raw.astype(np.float32)))
        ups = {"bicubic": bicubic, MODEL_METHOD: sr}
        metrics = method_metrics(ups, hr_img, dev)
        visualize_results(hr_img, lr_img01, ups, metrics,
                          os.path.join(output_dir, f"qualitative_{i}.png"),
                          logger)


def _load_engine_for(checkpoint, base_filters, quant="none", tta=False,
                     device=None):
    from mri_superresolution_torch.config import InferConfig, ModelConfig
    from mri_superresolution_torch.infer import load_engine
    return load_engine(InferConfig(
        model=ModelConfig(base_filters=base_filters),
        checkpoint_dir=os.path.dirname(str(checkpoint)) or ".",
        checkpoint_path=str(checkpoint), quant=quant, tta=tta),
        device=device)


def _evaluate_checkpoint(ckpt_path, test_pairs, output_dir, base_filters,
                         label, quant="none", tta=False, device=None):
    """The benchmark rows of one checkpoint, each with the checkpoint's
    label and implementation details as columns, and the figures."""
    impl = report_implementation_details(ckpt_path)
    engine = _load_engine_for(ckpt_path, base_filters, quant, tta, device)
    rows = run_benchmarks(test_pairs, engine)
    extra = {"checkpoint": label}
    for key, value in impl.items():
        col = str(key).replace(".", "_").replace(" ", "_")
        extra[col] = str(value) if isinstance(value, (list, dict)) else value
    rows = [dict(r, **extra) for r in rows]
    qualitative_comparison(test_pairs, engine,
                           os.path.join(output_dir, "qualitative", label))
    return rows, impl


def write_csv(rows, path) -> None:
    """Rows of dicts as CSV: the columns in order of first appearance,
    an empty cell where a row lacks one (as pandas' ``concat`` and
    ``to_csv`` write the JAX run's tables)."""
    columns = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=columns, restval="",
                           lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def _pairs(hr_dir, lr_dir):
    from mri_superresolution_torch.data import PairedSliceDataset
    return [(m["low_res_path"], m["full_res_path"])
            for m in PairedSliceDataset(hr_dir, lr_dir).metadata]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hr_dir", type=str, help="Test HR images")
    parser.add_argument("--lr_dir", type=str, help="Test LR images")
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--checkpoint", type=str)
    group.add_argument("--ablation_checkpoints_dir", type=str)
    parser.add_argument("--output_dir", type=str, default="./eval_results")
    parser.add_argument("--base_filters", type=int, default=32)
    parser.add_argument("--ablation_train_configs", type=str,
                        help="JSON list of dicts with loss weights; "
                             "trains each config in a process of its own")
    parser.add_argument("--device", type=str, default=None,
                        help="reference-parity alias (evaluate.py:139): "
                             "'cpu' means --cpu; any other value the card")
    parser.add_argument("--train_epochs", type=int, default=100)
    parser.add_argument("--train_batch_size", type=int, default=8)
    parser.add_argument("--train_num_workers", type=int, default=4,
                        help="reference-parity flag (evaluate.py:145), "
                             "passed on to the train CLI")
    parser.add_argument("--train_learning_rate", type=float, default=1e-4)
    parser.add_argument("--train_full_res_dir", type=str,
                        default="./training_data")
    parser.add_argument("--train_low_res_dir", type=str,
                        default="./training_data_1.5T")
    parser.add_argument("--quant", type=str, choices=["none", "int8"],
                        default="none",
                        help="int8 PTQ serving for the unet column "
                             "(streaming self-calibration; timings and "
                             "metrics then reflect quantized serving)")
    parser.add_argument("--tta", action="store_true",
                        help="dihedral-ensemble serving (timings and "
                             "metrics then reflect --tta inference)")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the GPU")
    return parser, parser.parse_args(argv)


def _train_configs(args, parser, device, hw):
    """``--ablation_train_configs``: train each loss configuration in a
    child process, then evaluate its best (else final) checkpoint."""
    from mri_superresolution_torch.utils.subproc import (child_env,
                                                         cli_command)

    if not args.hr_dir or not args.lr_dir:
        parser.error("--hr_dir and --lr_dir are required for "
                     "--ablation_train_configs")
    with open(args.ablation_train_configs) as f:
        ablation_configs = json.load(f)
    checkpoints_dir = "./ablation_checkpoints"
    os.makedirs(checkpoints_dir, exist_ok=True)
    all_rows, summary = [], {}
    for config in ablation_configs:
        ssim_w = config.get("ssim_weight", 0.0)
        perc_w = config.get("perceptual_weight", 0.0)
        name = f"ssim_{ssim_w}_perc_{perc_w}"
        ckpt_dir = os.path.join(checkpoints_dir, name)
        os.makedirs(ckpt_dir, exist_ok=True)
        cmd = cli_command("train") + [
            "--full_res_dir", args.train_full_res_dir,
            "--low_res_dir", args.train_low_res_dir,
            "--model_type", "unet", "--base_filters", "32",
            "--checkpoint_dir", ckpt_dir,
            "--epochs", str(args.train_epochs),
            "--batch_size", str(args.train_batch_size),
            "--learning_rate", str(args.train_learning_rate),
            "--num_workers", str(args.train_num_workers),
            "--ssim_weight", str(ssim_w),
            "--perceptual_weight", str(perc_w)]
        if args.cpu:
            cmd.append("--cpu")
        print(f"\nTraining config: {name}", flush=True)
        subprocess.run(cmd, check=True, env=child_env())
        best = os.path.join(ckpt_dir, "best_model_unet.ckpt")
        if not os.path.exists(best):
            best = os.path.join(ckpt_dir, "final_model_unet.ckpt")
        if not os.path.exists(best):
            print(f"No checkpoint found for {name}, skipping evaluation.")
            continue
        print(f"Evaluating config: {name}")
        eval_dir = os.path.join(args.output_dir, name)
        os.makedirs(eval_dir, exist_ok=True)
        ds = report_dataset_stats(args.hr_dir, args.lr_dir, eval_dir)
        impl = report_implementation_details(best)
        with open(os.path.join(eval_dir, "report.json"), "w") as f:
            json.dump({"hardware": hw, "dataset": ds,
                       "implementation": impl}, f, indent=2)
        rows, impl = _evaluate_checkpoint(
            best, _pairs(args.hr_dir, args.lr_dir), eval_dir, 32, name,
            quant=args.quant, tta=args.tta, device=device)
        write_csv(rows, os.path.join(eval_dir, "metrics.csv"))
        all_rows += rows
        summary[name] = impl
    if all_rows:
        write_csv(all_rows, os.path.join(args.output_dir,
                                         "metrics_ablation.csv"))
        with open(os.path.join(args.output_dir,
                               "ablation_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print("\nAblation training and evaluation complete. See",
          args.output_dir)
    return 0


def main(argv=None) -> int:
    parser, args = parse_args(argv)
    if args.device and args.device.lower() == "cpu":
        args.cpu = True
    from mri_superresolution_torch.utils.device import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        sys.exit(f"ERROR: {e}")

    os.makedirs(args.output_dir, exist_ok=True)
    hw = report_hardware(device)
    if args.ablation_train_configs:
        return _train_configs(args, parser, device, hw)

    ds = report_dataset_stats(args.hr_dir, args.lr_dir, args.output_dir)
    test_pairs = _pairs(args.hr_dir, args.lr_dir)

    if args.checkpoint:
        impl = report_implementation_details(args.checkpoint)
        with open(os.path.join(args.output_dir, "report.json"), "w") as f:
            json.dump({"hardware": hw, "dataset": ds,
                       "implementation": impl}, f, indent=2)
        print(f"Evaluating single checkpoint: {args.checkpoint}")
        rows, _ = _evaluate_checkpoint(
            args.checkpoint, test_pairs, args.output_dir, args.base_filters,
            os.path.basename(args.checkpoint), quant=args.quant,
            tta=args.tta, device=device)
        path = os.path.join(args.output_dir, "metrics.csv")
        write_csv(rows, path)
        print(f"Saved metrics to {path}")

    elif args.ablation_checkpoints_dir:
        with open(os.path.join(args.output_dir, "report_base.json"), "w") as f:
            json.dump({"hardware": hw, "dataset": ds}, f, indent=2)
        root = Path(args.ablation_checkpoints_dir)
        files = sorted(list(root.glob("*.ckpt")) + list(root.glob("*.pth")))
        if not files:
            print(f"Error: No checkpoint files found in "
                  f"{args.ablation_checkpoints_dir}")
            return 1
        all_rows, summary = [], {}
        for p in files:
            print(f"\n--- Evaluating Checkpoint: {p.name} ---")
            rows, impl = _evaluate_checkpoint(
                p, test_pairs, args.output_dir, 32,
                p.name.replace(".ckpt", "").replace(".pth", ""),
                quant=args.quant, tta=args.tta, device=device)
            all_rows += rows
            summary[p.name] = impl
        write_csv(all_rows, os.path.join(args.output_dir,
                                         "metrics_ablation.csv"))
        with open(os.path.join(args.output_dir,
                               "ablation_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)

    print("\nEvaluation complete. See", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
