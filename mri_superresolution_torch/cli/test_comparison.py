"""The model against the classical interpolation baselines on one
extracted slice pair.

    python -m mri_superresolution_torch.cli.test_comparison \
        [--test_dataset ./test_dataset] [--output_dir ./test_results] \
        [--checkpoint_dir ./checkpoints] [--seed N] [--tta] [--cpu]

Takes the flags of the JAX package's ``scripts/test_comparison.py``
(reference scripts/test_comparison.py:259-353): 10 slices of the first
volume's central 45-55% band extracted at 256x256, one pair picked at
random, upscaled by the model and by bilinear, sharp-bilinear and bicubic
interpolation; SSIM/PSNR/MSE/RMSE/MAE of the four in one
``metric_suites`` call (one launch of kernel B2 over the (4, H, W) batch
on the card), a markdown ``metrics.txt`` table and a comparison figure
(matplotlib; skipped with a warning without it). Runs on the card;
``--cpu`` runs on the CPU.

The pair is picked from the extracted names in sorted order. The JAX
script picks from ``os.listdir``'s order, which differs between
filesystems, so one ``--seed`` can pick another pair on another machine.
"""

from __future__ import annotations

import argparse
import os
import random
import sys


def extract_test_slice(test_dataset_dir, hr_dir, lr_dir, logger, seed=None,
                       device=None):
    """Extract 10 central slices of the first anat NIfTI and pick one pair
    (parity: scripts/test_comparison.py:34-90); {"hr", "lr"} paths or
    None."""
    from mri_superresolution_torch.data.extraction import (
        extract_from_nifti, find_nifti_files)

    files = find_nifti_files(test_dataset_dir)
    if not files:
        logger.error("No NIfTI files found in test dataset")
        return None
    nifti_file = files[0]
    logger.info(f"Using NIfTI file: {nifti_file}")
    try:
        extract_from_nifti(nifti_file, hr_dir, lr_dir, seed=seed or 0,
                           device=device, n_slices=10, lower_percent=0.45,
                           upper_percent=0.55, target_size=(256, 256),
                           noise_std=5, kspace_crop_factor=0.5,
                           verbose=False)
    except Exception as e:  # reported, and the CLI exits 1
        logger.error(f"Error extracting slice from {nifti_file}: {e}")
        return None
    hr_files = [f for f in os.listdir(hr_dir) if f.endswith(".png")]
    lr_files = set(f for f in os.listdir(lr_dir) if f.endswith(".png"))
    matching = sorted(f for f in hr_files if f in lr_files)
    if not matching:
        logger.error("No matching pairs extracted")
        return None
    chosen = random.choice(matching)
    return {"hr": os.path.join(hr_dir, chosen),
            "lr": os.path.join(lr_dir, chosen)}


def visualize_results(hr_image, lr_image, upscaled_images, metrics,
                      output_path, logger) -> bool:
    """2-row figure of the images and their difference maps (parity:
    scripts/test_comparison.py:204-257); False without matplotlib."""
    import numpy as np

    from mri_superresolution_torch.utils.figures import pyplot

    plt = pyplot()
    if plt is None:
        return False
    n_cols = len(upscaled_images) + 2
    plt.figure(figsize=(n_cols * 4, 8))
    plt.subplot(2, n_cols, 1)
    plt.imshow(hr_image, cmap="gray", vmin=0, vmax=1)
    plt.title("HR Reference")
    plt.axis("off")
    plt.subplot(2, n_cols, 2)
    plt.imshow(lr_image, cmap="gray", vmin=0, vmax=1)
    plt.title("LR Input")
    plt.axis("off")
    col = 3
    for method, image in upscaled_images.items():
        plt.subplot(2, n_cols, col)
        plt.imshow(image, cmap="gray", vmin=0, vmax=1)
        plt.title(f"{method}\nSSIM: {metrics[method]['ssim']:.4f}\n"
                  f"PSNR: {metrics[method]['psnr']:.2f}")
        plt.axis("off")
        plt.subplot(2, n_cols, col + n_cols)
        plt.imshow(np.abs(hr_image - image), cmap="hot", vmin=0, vmax=0.5)
        plt.title(f"Difference Map\nMAE: {metrics[method]['mae']:.4f}")
        plt.axis("off")
        col += 1
    plt.tight_layout()
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close()
    logger.info(f"Saved visualization to {output_path}")
    return True


def method_metrics(upscaled, hr_image, device):
    """``metric_suites`` of each upscaled image against the HR image, in
    one call over the (N, H, W) stack: {method: metrics}."""
    import numpy as np
    import torch

    from mri_superresolution_torch.ops.metrics import metric_suites

    names = list(upscaled)
    out = torch.from_numpy(np.stack([upscaled[k] for k in names]).astype(
        np.float32)).to(device)
    hr = torch.from_numpy(np.ascontiguousarray(hr_image, np.float32)).to(
        device).expand_as(out).contiguous()
    return dict(zip(names, metric_suites(out, hr)))


def write_metrics_table(path: str, test_file: str, metrics) -> None:
    """The JAX script's markdown ``metrics.txt``."""
    with open(path, "w") as f:
        f.write("# Super-Resolution Comparison Metrics\n\n")
        f.write(f"Test file: {test_file}\n\n")
        f.write("| Method | SSIM | PSNR | MSE | RMSE | MAE |\n")
        f.write("| --- | --- | --- | --- | --- | --- |\n")
        for method, m in metrics.items():
            f.write(f"| {method} | {m['ssim']:.4f} | {m['psnr']:.2f} | "
                    f"{m['mse']:.6f} | {m['rmse']:.4f} | {m['mae']:.4f} |\n")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Test and compare upscaling methods")
    parser.add_argument('--test_dataset', type=str, default='./test_dataset')
    parser.add_argument('--output_dir', type=str, default='./test_results')
    parser.add_argument('--checkpoint_dir', type=str, default='./checkpoints')
    parser.add_argument('--model_type', type=str, default='unet')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--tta', action='store_true',
                        help='Dihedral-ensemble serving for the model '
                             'column')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU instead of the GPU')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.seed is not None:
        random.seed(args.seed)

    import numpy as np
    import torch

    from mri_superresolution_torch import native
    from mri_superresolution_torch.config import InferConfig, ModelConfig
    from mri_superresolution_torch.evalsuite.baselines import (
        INTERP_METHODS, upscale_with_interpolation)
    from mri_superresolution_torch.infer import (load_engine,
                                                 preprocess_image_array)
    from mri_superresolution_torch.utils.device import resolve_device
    from mri_superresolution_torch.utils.logging import setup_logging

    logger = setup_logging("test_model.log")
    device = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.output_dir, exist_ok=True)
    hr_dir = os.path.join(args.output_dir, "hr")
    lr_dir = os.path.join(args.output_dir, "lr")
    os.makedirs(hr_dir, exist_ok=True)
    os.makedirs(lr_dir, exist_ok=True)

    logger.info("Extracting test slice...")
    paired = extract_test_slice(args.test_dataset, hr_dir, lr_dir, logger,
                                args.seed, device)
    if not paired:
        logger.error("Failed to extract test slice")
        return 1
    logger.info(f"Test files: HR={paired['hr']}, LR={paired['lr']}")

    logger.info("Loading model...")
    try:
        engine = load_engine(InferConfig(
            model=ModelConfig(model_type=args.model_type),
            checkpoint_dir=args.checkpoint_dir, tta=args.tta), device=device)
    except Exception as e:  # reported, and the CLI exits 1
        logger.error(f"Error loading model: {e}")
        return 1

    raw_hr = native.imread_gray(paired["hr"])
    raw_lr = native.imread_gray(paired["lr"])
    hr_image = raw_hr.astype(np.float32) / 255.0
    lr_image = raw_lr.astype(np.float32) / 255.0

    upscaled = {}
    logger.info("Upscaling with AI model...")
    # the model sees the same percentile-normalized input as cli/infer.py
    upscaled["AI Model"] = engine.upscale_image(
        preprocess_image_array(raw_lr.astype(np.float32)))
    lr_dev = torch.from_numpy(lr_image).to(device)
    for method in INTERP_METHODS:
        logger.info(f"Upscaling with {method}...")
        name = method.replace("_", " ").title()
        upscaled[name] = upscale_with_interpolation(
            lr_dev, method).cpu().numpy()

    metrics = method_metrics(upscaled, hr_image, device)
    for method, m in metrics.items():
        logger.info(f"Metrics for {method}: {m}")

    visualize_results(hr_image, lr_image, upscaled, metrics,
                      os.path.join(args.output_dir, "comparison.png"), logger)
    write_metrics_table(os.path.join(args.output_dir, "metrics.txt"),
                        os.path.basename(paired["hr"]), metrics)
    logger.info(f"Results saved to {args.output_dir}")
    logger.info("Testing complete!")
    return 0


if __name__ == '__main__':
    sys.exit(main())
