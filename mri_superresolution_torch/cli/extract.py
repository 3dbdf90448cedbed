"""Extract paired HR/LR PNG slices from NIfTI datasets on the GPU.

    python -m mri_superresolution_torch.cli.extract --datasets_dir ./datasets \
        --hr_output_dir ./training_data --lr_output_dir ./training_data_1.5T \
        [--n_slices 10] [--target_size 256 256] [--noise_std 5] [--seed 0]
        [--cpu] [--stage_times]

The port's counterpart of the JAX package's
``scripts/extract_paired_slices.py``, with its flags and defaults (the
reference's scripts/extract_paired_slices.py:97-122, plus ``--seed``):
every volume under an ``anat/`` folder of ``--datasets_dir`` goes through
``data/extraction.extract_from_nifti``, its slices one batch on the card.
Runs on the card; ``--cpu`` runs on the CPU. File i of the run seeds its
noise generator with ``sub_seed(--seed, i)`` (timepoint t of a 4D volume
with ``sub_seed`` of that, t): the same seed gives the same PNGs on one
device, but not JAX's bits. A file that fails is reported ("Error
processing <file>: <error>") and the run goes on to the next one; the exit
status is then 1. The last line gives the slices a second and, with
``--stage_times`` (which synchronizes the card at the end of every stage),
each stage's milliseconds.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract both full-resolution and simulated "
                    "low-resolution slices from NIfTI scans.")
    parser.add_argument('--datasets_dir', type=str, default='./datasets')
    parser.add_argument('--hr_output_dir', type=str,
                        default='./training_data')
    parser.add_argument('--lr_output_dir', type=str,
                        default='./training_data_1.5T')
    parser.add_argument('--n_slices', type=int, default=10)
    parser.add_argument('--lower_percent', type=float, default=0.2)
    parser.add_argument('--upper_percent', type=float, default=0.8)
    parser.add_argument('--target_size', type=int, nargs=2,
                        default=[256, 256], help='Target size (width height)')
    parser.add_argument('--noise_std', type=float, default=5)
    parser.add_argument('--kspace_crop_factor', type=float, default=0.5)
    parser.add_argument('--seed', type=int, default=0,
                        help='RNG seed for the simulated noise')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU instead of the GPU')
    parser.add_argument('--stage_times', action='store_true',
                        help='Synchronize the GPU at the end of every stage '
                             'and report each stage\'s milliseconds')
    return parser.parse_args(argv)


def run(args) -> dict:
    """Extract every volume; a summary: ``rc`` (1 if a file failed),
    ``files``, ``failed``, ``slices``, ``seconds`` and ``stage_ms``
    (``data/extraction.StageTimes``, each stage synchronized with
    ``--stage_times``)."""
    from mri_superresolution_torch.data.extraction import (
        StageTimes, extract_from_nifti, find_nifti_files, sub_seed)
    from mri_superresolution_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.hr_output_dir, exist_ok=True)
    if args.lr_output_dir:
        os.makedirs(args.lr_output_dir, exist_ok=True)

    print(f"=== MRI Paired Slice Extraction ({device.type}) ===")
    print(f"Datasets Directory: {args.datasets_dir}")
    print(f"High-Resolution Output: {args.hr_output_dir} "
          "(LANCZOS letterbox)")
    if args.lr_output_dir:
        print(f"Low-Resolution Output: {args.lr_output_dir} "
              "(k-space simulation + AREA letterbox)")
        print(f"  - K-space Crop Factor: {args.kspace_crop_factor}")
        print(f"  - Noise Standard Deviation: {args.noise_std}")
    print("==========================================")

    times = StageTimes(sync=args.stage_times)
    summary = {"rc": 0, "files": 0, "failed": 0, "slices": 0,
               "seconds": 0.0, "stage_ms": times.ms}
    files = find_nifti_files(args.datasets_dir)
    if not files:
        print(f"No NIfTI files found under {args.datasets_dir} "
              "(only anat/ directories are scanned)")
        return summary
    t0 = time.perf_counter()
    for i, nifti_path in enumerate(files):
        print(f"Processing {nifti_path}")
        try:
            extract_from_nifti(
                nifti_path, args.hr_output_dir, args.lr_output_dir or None,
                seed=sub_seed(args.seed, i), device=device, times=times,
                n_slices=args.n_slices, lower_percent=args.lower_percent,
                upper_percent=args.upper_percent,
                target_size=tuple(args.target_size),
                noise_std=args.noise_std,
                kspace_crop_factor=args.kspace_crop_factor)
        except Exception as e:  # one bad file must not stop the run
            print(f"Error processing {nifti_path}: {e}")
            summary["failed"] += 1
    summary.update(rc=int(summary["failed"] > 0), files=len(files),
                   slices=times.slices,
                   seconds=time.perf_counter() - t0)
    stages = ", ".join(f"{k} {v:.1f}" for k, v in times.ms.items())
    print(f"Extracted {times.slices} slice pairs from "
          f"{len(files) - summary['failed']}/{len(files)} files in "
          f"{summary['seconds']:.2f} s "
          f"({times.slices / max(summary['seconds'], 1e-9):.1f} slices/s)"
          + (f"; ms by stage: {stages}" if args.stage_times else ""))
    return summary


def main(argv=None) -> int:
    return run(parse_args(argv))["rc"]


if __name__ == '__main__':
    sys.exit(main())
