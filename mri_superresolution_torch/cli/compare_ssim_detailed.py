"""Side-by-side outputs of the models of an SSIM-weight sweep.

    python -m mri_superresolution_torch.cli.compare_ssim_detailed \
        --weight_dirs SWEEP_DIR --test_image_dir lr/ \
        [--output_dir ./ssim_detailed_comparison] [--cpu]

Takes the flags of the JAX package's ``scripts/compare_ssim_detailed.py``
(reference scripts/compare_ssim_detailed.py:11-185): finds the
``ssim_weight_{w}/`` run directories that ``cli/test_ssim_weights.py``
writes, loads each run's best checkpoint, and runs up to 5 test images
through every model: per image a directory with ``original.png``, one
``weight_{w}.png`` a model at full resolution, and a side-by-side
``comparison.png`` (matplotlib; skipped with a warning without it). Runs
on the card; ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def find_weight_dirs(root: str):
    """{weight: path} of the ``ssim_weight_{w}`` directories in root."""
    weight_dirs = {}
    for dirname in os.listdir(root):
        if dirname.startswith("ssim_weight_"):
            try:
                weight = float(dirname.replace("ssim_weight_", ""))
            except ValueError:
                continue
            weight_dirs[weight] = os.path.join(root, dirname)
    return weight_dirs


def create_detailed_comparison(weight_dirs, test_image_dir, output_dir,
                               model_type="unet", device=None):
    """Every test image through every loadable model; returns {image
    stem: [written file names]}."""
    import numpy as np

    from mri_superresolution_torch import native
    from mri_superresolution_torch.config import InferConfig, ModelConfig
    from mri_superresolution_torch.infer import load_engine
    from mri_superresolution_torch.utils.figures import pyplot

    engines = {}
    for weight, dir_path in weight_dirs.items():
        try:
            engines[weight] = load_engine(InferConfig(
                model=ModelConfig(model_type=model_type),
                checkpoint_dir=dir_path), device=device)
            print(f"Loaded model for SSIM weight {weight} from {dir_path}")
        except FileNotFoundError:
            print(f"Warning: No checkpoint found for SSIM weight {weight} "
                  f"in {dir_path}")
        except Exception as e:  # one bad run does not stop the others
            print(f"Error loading checkpoint for SSIM weight {weight}: {e}")

    test_images = sorted(
        glob.glob(os.path.join(test_image_dir, "*.png")) +
        glob.glob(os.path.join(test_image_dir, "*.jpg")) +
        glob.glob(os.path.join(test_image_dir, "*.tif")))[:5]
    if not test_images:
        print(f"No test images found in {test_image_dir}")
        return {}
    if not engines:
        print("No models loaded, skipping comparison")
        return {}

    os.makedirs(output_dir, exist_ok=True)
    written = {}
    for img_path in test_images:
        img_name = os.path.basename(img_path)
        print(f"Processing test image: {img_name}")
        stem = os.path.splitext(img_name)[0]
        img_output_dir = os.path.join(output_dir, stem)
        os.makedirs(img_output_dir, exist_ok=True)

        if img_path.endswith(".png"):
            raw = native.imread_gray(img_path)
        else:
            import cv2
            raw = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)
        native.imwrite_gray(os.path.join(img_output_dir, "original.png"), raw)
        img01 = raw.astype(np.float32) / 255.0
        files = ["original.png"]
        outs = {}
        for weight, engine in sorted(engines.items()):
            out = engine.upscale_image(img01)
            name = f"weight_{weight}.png"
            native.imwrite_gray(os.path.join(img_output_dir, name),
                                np.clip(out * 255, 0, 255).astype(np.uint8))
            files.append(name)
            outs[weight] = out

        plt = pyplot()
        if plt is not None:
            n = len(engines)
            fig, axes = plt.subplots(1, n + 1, figsize=(5 * (n + 1), 5))
            axes[0].imshow(raw, cmap="gray")
            axes[0].set_title("Original Low-Res")
            axes[0].axis("off")
            for i, (weight, out) in enumerate(outs.items()):
                axes[i + 1].imshow(out, cmap="gray")
                axes[i + 1].set_title(f"SSIM Weight: {weight}")
                axes[i + 1].axis("off")
            plt.tight_layout()
            plt.savefig(os.path.join(img_output_dir, "comparison.png"),
                        dpi=150)
            plt.close(fig)
            files.append("comparison.png")
        written[stem] = files

    print(f"Detailed comparison saved to {output_dir}")
    print("Individual full-resolution images saved in subdirectories "
          "for each test image")
    return written


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Create detailed comparison of MRI Super-resolution "
                    "with different SSIM weights")
    parser.add_argument('--weight_dirs', type=str, required=True)
    parser.add_argument('--test_image_dir', type=str, required=True)
    parser.add_argument('--model_type', type=str,
                        choices=['unet', 'unet_tpu', 'edsr', 'simple'],
                        default='unet')
    parser.add_argument('--output_dir', type=str,
                        default='./ssim_detailed_comparison')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU instead of the GPU')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from mri_superresolution_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    weight_dirs = find_weight_dirs(args.weight_dirs)
    if not weight_dirs:
        print(f"No weight directories found in {args.weight_dirs}")
        return 0
    print(f"Found {len(weight_dirs)} weight directories: "
          f"{sorted(weight_dirs.keys())}")
    create_detailed_comparison(weight_dirs, args.test_image_dir,
                               args.output_dir, args.model_type, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
