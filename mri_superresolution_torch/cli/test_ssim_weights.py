"""SSIM-weight sweep: one training run a weight, then a collage.

    python -m mri_superresolution_torch.cli.test_ssim_weights \
        --full_res_dir hr --low_res_dir lr [--ssim_weights 0.0 0.3 ...] \
        [--epochs 20] [--output_dir ./ssim_weight_comparison] [--cpu]

Takes the flags of the JAX package's ``scripts/test_ssim_weights.py``
(reference scripts/test_ssim_weights.py:9-145): one run of
``python -m mri_superresolution_torch.cli.train`` a weight, one after
another, into ``ssim_weight_{w}/`` under a timestamped output directory,
each on the card unless ``--cpu`` is given; then a vertical collage of
each run's latest ``samples/comparison_epoch_*.png`` grid. The trainer
writes those grids and this collage only where matplotlib is installed;
without it the collage is skipped with a warning.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
from datetime import datetime


def train_command(args, ssim_weight, weight_dir):
    """The train CLI's command line of one weight's run."""
    from mri_superresolution_torch.utils.subproc import cli_command

    cmd = cli_command("train") + [
        "--full_res_dir", args.full_res_dir,
        "--low_res_dir", args.low_res_dir,
        "--model_type", args.model_type,
        "--batch_size", str(args.batch_size),
        "--epochs", str(args.epochs),
        "--ssim_weight", str(ssim_weight),
        "--checkpoint_dir", weight_dir,
        "--log_dir", os.path.join(weight_dir, "logs"),
    ]
    if args.augmentation:
        cmd.append("--augmentation")
    if args.use_amp:
        cmd.append("--use_amp")   # bf16 compute, the train CLI's default
    if args.cpu:
        cmd.append("--cpu")
    return cmd


def run_training_with_ssim_weight(args, ssim_weight, output_dir):
    from mri_superresolution_torch.utils.subproc import child_env

    weight_dir = os.path.join(output_dir, f"ssim_weight_{ssim_weight}")
    os.makedirs(weight_dir, exist_ok=True)
    print(f"Starting training with SSIM weight: {ssim_weight}", flush=True)
    subprocess.run(train_command(args, ssim_weight, weight_dir), check=True,
                   env=child_env())
    return weight_dir


def create_ssim_weight_collage(weight_dirs, output_path, epoch=-1) -> bool:
    """Vertical collage of each run's sample grid (parity:
    scripts/test_ssim_weights.py:42-90); False without matplotlib."""
    from mri_superresolution_torch.utils.figures import pyplot

    plt = pyplot()
    if plt is None:
        return False
    ssim_weights = sorted(weight_dirs.keys())
    fig = plt.figure(figsize=(15, 5 * len(ssim_weights)))
    for i, weight in enumerate(ssim_weights):
        sample_dir = os.path.join(weight_dirs[weight], "samples")
        if not os.path.exists(sample_dir):
            print(f"Warning: No samples found for SSIM weight {weight}")
            continue
        if epoch >= 0:
            image_path = os.path.join(sample_dir,
                                      f"comparison_epoch_{epoch}.png")
        else:
            files = glob.glob(os.path.join(sample_dir,
                                           "comparison_epoch_*.png"))
            if not files:
                print(f"Warning: No comparison images for weight {weight}")
                continue
            image_path = max(files, key=os.path.getctime)
        if not os.path.exists(image_path):
            print(f"Warning: Image {image_path} not found")
            continue
        ax = fig.add_subplot(len(ssim_weights), 1, i + 1)
        ax.imshow(plt.imread(image_path))
        ax.set_title(f"SSIM Weight: {weight}")
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(output_path, dpi=150)
    plt.close()
    print(f"Collage saved to {output_path}")
    return True


def parse_args(argv=None):
    from mri_superresolution_torch.models.families import jax_families
    parser = argparse.ArgumentParser(
        description="Test various SSIM weights for MRI Super-resolution")
    parser.add_argument('--full_res_dir', type=str, required=True)
    parser.add_argument('--low_res_dir', type=str, required=True)
    parser.add_argument('--ssim_weights', type=float, nargs='+',
                        default=[0.0, 0.3, 0.5, 0.7, 1.0])
    parser.add_argument('--model_type', type=str, choices=jax_families(),
                        default='unet')
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--epochs', type=int, default=20)
    parser.add_argument('--augmentation', action='store_true')
    parser.add_argument('--use_amp', action='store_true',
                        help='Forwarded to the train CLI (bf16 compute, '
                             'its default)')
    parser.add_argument('--cpu', action='store_true',
                        help='Train on the CPU instead of the GPU')
    parser.add_argument('--output_dir', type=str,
                        default='./ssim_weight_comparison')
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Run the sweep; returns the timestamped output directory."""
    args = parse_args(argv)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    output_dir = f"{args.output_dir}_{timestamp}"
    os.makedirs(output_dir, exist_ok=True)

    weight_dirs = {}
    for weight in args.ssim_weights:
        weight_dirs[weight] = run_training_with_ssim_weight(
            args, weight, output_dir)

    create_ssim_weight_collage(
        weight_dirs, os.path.join(output_dir, "ssim_weight_comparison.png"))
    print(f"\nAll trainings completed. Results saved to {output_dir}")
    return output_dir


if __name__ == "__main__":
    main()
