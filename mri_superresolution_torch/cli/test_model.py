"""End-to-end evaluation of a checkpoint on a fresh NIfTI test set.

    python -m mri_superresolution_torch.cli.test_model \
        [--test_dataset ./test_dataset] [--output_dir ./test_results] \
        [--checkpoint_dir ./checkpoints] [--n_slices 10] [--quant int8] \
        [--tta] [--cpu]

Takes the flags of the JAX package's ``scripts/test_model.py`` (reference
scripts/test_model.py:293-401): the average native slice resolution over
all test volumes, a square HR size divisible by 8 from it, pairs
extracted at the average size and re-padded onto square canvases, each
pair through the engine (``process_single_image``: histogram-matched
output PNG and SSIM/RMSE/MAE), the average metrics, and a summary grid
(matplotlib; skipped with a warning without it). Runs on the card;
``--cpu`` runs on the CPU. The LR noise comes from the port's generator
(``sub_seed(--seed, i)`` for the i-th volume, as ``cli/extract.py``
seeds it), so the LR images are not the JAX script's draws.
"""

from __future__ import annotations

import argparse
import os
import random
import sys


def average_resolution(nifti_files, logger):
    """(avg_w, avg_h) over every slice of the volumes, or None when none
    has slices (parity: scripts/test_model.py:50-80)."""
    from mri_superresolution_torch import nifti

    total_w = total_h = total_slices = 0
    for nf in nifti_files:
        try:
            data, _ = nifti.load(nf)
            if data.ndim >= 3:
                height, width = data.shape[:2]
                cnt = data.shape[2]
                total_w += width * cnt
                total_h += height * cnt
                total_slices += cnt
                logger.info(f"File {os.path.basename(nf)}: "
                            f"{width}x{height}, {cnt} slices")
        except Exception as e:  # one unreadable volume is skipped
            logger.error(f"Error analyzing resolution for {nf}: {e}")
    if total_slices == 0:
        return None
    return int(total_w / total_slices), int(total_h / total_slices)


def square_sizes(avg_w: int, avg_h: int):
    """(hr_size, lr_size): the larger average side rounded up to a
    multiple of 8, and half of it."""
    hr_size = max(avg_w, avg_h)
    if hr_size % 8 != 0:
        hr_size = ((hr_size // 8) + 1) * 8
    return hr_size, hr_size // 2


def pad_to_square(img, size: int):
    """``img`` centered on a zero (size, size) uint8 canvas."""
    import numpy as np

    canvas = np.zeros((size, size), np.uint8)
    y0 = (size - img.shape[0]) // 2
    x0 = (size - img.shape[1]) // 2
    canvas[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
    return canvas


def repad_dir(directory: str, size: int) -> None:
    """Every PNG in ``directory`` re-padded onto a square canvas."""
    from mri_superresolution_torch import native

    for f in sorted(os.listdir(directory)):
        if f.endswith(".png"):
            p = os.path.join(directory, f)
            native.imwrite_gray(p, pad_to_square(native.imread_gray(p), size))


def extract_test_slices(test_dataset_dir, hr_output_dir, lr_output_dir,
                        n_slices, logger, seed=0, device=None):
    """Average-resolution analysis, extraction at that size, re-padding
    onto square %8 canvases, and ``random.sample`` of the sorted pairs
    (parity: scripts/test_model.py:34-188); [(lr, hr)] paths or None."""
    from mri_superresolution_torch.data.extraction import (
        extract_from_nifti, find_nifti_files, sub_seed)

    os.makedirs(hr_output_dir, exist_ok=True)
    os.makedirs(lr_output_dir, exist_ok=True)
    nifti_files = find_nifti_files(test_dataset_dir)
    if not nifti_files:
        logger.error(f"No NIfTI files found in 'anat' folders within "
                     f"{test_dataset_dir}")
        return None
    logger.info(f"Found {len(nifti_files)} NIfTI files in 'anat' folders.")

    avg = average_resolution(nifti_files, logger)
    if avg is None:
        logger.error("No valid slices found in NIfTI files.")
        return None
    avg_w, avg_h = avg
    logger.info(f"Average slice resolution: {avg_w}x{avg_h}")
    hr_size, lr_size = square_sizes(avg_w, avg_h)
    logger.info(f"Setting HR target size to square and divisible by 8: "
                f"{hr_size}x{hr_size} (LR {lr_size}x{lr_size})")

    for i, nf in enumerate(nifti_files):
        try:
            extract_from_nifti(nf, hr_output_dir, lr_output_dir,
                               seed=sub_seed(seed, i), device=device,
                               n_slices=n_slices // len(nifti_files) + 1,
                               lower_percent=0.2, upper_percent=0.8,
                               target_size=(avg_w, avg_h), verbose=False)
        except Exception as e:  # one bad volume does not stop the run
            logger.error(f"Error extracting slices from {nf}: {e}")

    repad_dir(hr_output_dir, hr_size)
    repad_dir(lr_output_dir, lr_size)

    hr_files = [f for f in os.listdir(hr_output_dir) if f.endswith(".png")]
    lr_files = set(f for f in os.listdir(lr_output_dir) if f.endswith(".png"))
    paired = [(os.path.join(lr_output_dir, f), os.path.join(hr_output_dir, f))
              for f in sorted(hr_files) if f in lr_files]
    if len(paired) > n_slices:
        paired = random.sample(paired, n_slices)
    logger.info(f"Extracted {len(paired)} paired slices for testing")
    return paired


def average_metrics(results):
    """{metric: mean over the results}, in the metrics' order."""
    avg = {}
    for r in results:
        for k, v in (r["metrics"] or {}).items():
            avg[k] = avg.get(k, 0) + v
    return {k: v / len(results) for k, v in avg.items()}


def create_summary_visualization(results, output_path, logger) -> bool:
    """Grid of input/output/target rows under the average metrics (parity:
    scripts/test_model.py:226-291); False without results or
    matplotlib."""
    from mri_superresolution_torch import native
    from mri_superresolution_torch.utils.figures import pyplot

    n = len(results)
    if n == 0:
        logger.error("No results to visualize")
        return False
    plt = pyplot()
    if plt is None:
        return False
    cols = min(4, n)
    rows = (n + cols - 1) // cols * 3
    plt.figure(figsize=(cols * 5, rows * 5))
    title = "Model Evaluation Results\n" + " | ".join(
        f"{k.upper()}: {v:.4f}" for k, v in average_metrics(results).items())
    plt.suptitle(title, fontsize=16)
    for i, r in enumerate(results):
        row_idx = (i // cols) * 3
        col_idx = i % cols
        imgs = [native.imread_gray(r[k]) for k in ("input", "output",
                                                   "target")]
        for j, (img, label) in enumerate(zip(imgs, ("Input", "Output",
                                                    "Target"))):
            plt.subplot(rows, cols, (row_idx + j) * cols + col_idx + 1)
            plt.imshow(img, cmap="gray", interpolation="none")
            if label == "Output" and r["metrics"]:
                mt = "\n".join(f"{k.upper()}: {v:.4f}"
                               for k, v in r["metrics"].items())
                plt.title(f"{label} {i + 1}\n{mt}", fontsize=8)
            else:
                plt.title(f"{label} {i + 1}")
            plt.axis("off")
    plt.tight_layout()
    plt.subplots_adjust(top=0.95)
    plt.savefig(output_path, dpi=300, bbox_inches="tight")
    logger.info(f"Saved visualization to {output_path}")
    plt.close()
    return True


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Test MRI super-resolution model on new dataset")
    parser.add_argument('--test_dataset', type=str, default='./test_dataset')
    parser.add_argument('--output_dir', type=str, default='./test_results')
    parser.add_argument('--checkpoint_dir', type=str, default='./checkpoints')
    parser.add_argument('--checkpoint_path', type=str, default=None)
    parser.add_argument('--model_type', type=str,
                        choices=['unet', 'unet_tpu', 'edsr', 'simple'],
                        default='unet')
    parser.add_argument('--base_filters', type=int, default=32)
    parser.add_argument('--n_slices', type=int, default=10)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--bucket', type=int, default=1,
                        help='Pad inputs to a multiple of this (1 = native '
                             'size, GroupNorm-exact)')
    parser.add_argument('--quant', type=str, choices=['none', 'int8'],
                        default='none',
                        help='int8 PTQ serving: streaming self-calibration '
                             'over the first slices (served bf16), then '
                             'int8 (see --quant_calib_slices)')
    parser.add_argument('--tta', action='store_true',
                        help='Dihedral-ensemble serving (metrics then '
                             'reflect --tta inference)')
    parser.add_argument('--quant_calib_slices', type=int, default=2,
                        help='slices of streaming calibration before int8 '
                             'serving starts (kept small so most reported '
                             'metrics are int8-served)')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU instead of the GPU')
    parser.add_argument('--use_amp', action='store_true',
                        help='Reference-compat alias (bf16 default)')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    random.seed(args.seed)

    from mri_superresolution_torch.config import InferConfig, ModelConfig
    from mri_superresolution_torch.infer import load_engine
    from mri_superresolution_torch.utils.device import resolve_device
    from mri_superresolution_torch.utils.logging import setup_logging

    logger = setup_logging("test_model.log")
    try:
        device = resolve_device("cpu" if args.cpu else None)
        os.makedirs(args.output_dir, exist_ok=True)
        hr_dir = os.path.join(args.output_dir, "hr_slices")
        lr_dir = os.path.join(args.output_dir, "lr_slices")
        enhanced_dir = os.path.join(args.output_dir, "enhanced")
        os.makedirs(enhanced_dir, exist_ok=True)

        paired = extract_test_slices(args.test_dataset, hr_dir, lr_dir,
                                     args.n_slices, logger, args.seed,
                                     device)
        if not paired:
            logger.error("No paired slices extracted. Exiting.")
            return 1

        engine = load_engine(InferConfig(
            model=ModelConfig(model_type=args.model_type,
                              base_filters=args.base_filters),
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_path=args.checkpoint_path, bucket=args.bucket,
            quant=args.quant,
            quant_calib_slices=args.quant_calib_slices, tta=args.tta),
            device=device)

        results = []
        for i, (lr_file, hr_file) in enumerate(paired):
            logger.info(f"Processing slice {i + 1}/{len(paired)}: "
                        f"{os.path.basename(lr_file)}")
            out_file = os.path.join(enhanced_dir,
                                    f"enhanced_{os.path.basename(lr_file)}")
            try:
                _, metrics = engine.process_single_image(
                    lr_file, out_file, hr_file)
                results.append({"input": lr_file, "target": hr_file,
                                "output": out_file, "metrics": metrics})
            except Exception as e:  # one bad slice is reported, skipped
                logger.error(f"Error processing {lr_file}: {e}")

        if results:
            create_summary_visualization(
                results, os.path.join(args.output_dir, "results_summary.png"),
                logger)
            logger.info("=== Testing Results Summary ===")
            for k, v in average_metrics(results).items():
                logger.info(f"Average {k.upper()}: {v:.4f}")
        logger.info("Testing completed successfully!")
        return 0
    except Exception as e:  # the CLI boundary: report and exit 1
        logger.error(f"Error during testing: {e}")
        return 1


if __name__ == '__main__':
    sys.exit(main())
