"""Native spatial resolutions of NIfTI datasets.

    python -m mri_superresolution_torch.cli.visualise_res \
        [--root_dir ./datasets] [--output_png_dir ./png_slices] \
        [--output_viz_file spatial_resolution_histogram.png]

Takes the flags of the JAX package's ``scripts/visualise_res.py``
(reference utils/visualise_res.py:275-339): finds the NIfTI files in
``anat/`` folders, writes each volume's middle slice as a native-resolution
PNG, prints the Width/Height/Count table and plots it (the plots need
matplotlib; without it they are skipped with a warning). Host only: no
device is touched.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Analyze original spatial resolutions of NIfTI slices")
    parser.add_argument('--root_dir', type=str, default='./datasets')
    parser.add_argument('--output_png_dir', type=str, default='./png_slices')
    parser.add_argument('--output_viz_file', type=str,
                        default='spatial_resolution_histogram.png')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from mri_superresolution_torch.data.extraction import find_nifti_files
    from mri_superresolution_torch.evalsuite.resolution import (
        analyze_resolutions, extract_middle_slice, format_table,
        visualize_resolution_histogram)

    files = find_nifti_files(args.root_dir)
    if not files:
        print(f"No NIfTI files found in anat/ folders under {args.root_dir}")
        return 1
    print(f"Found {len(files)} NIfTI files")
    rows = analyze_resolutions([extract_middle_slice(f, args.output_png_dir)
                                for f in files])
    print(format_table(rows))
    visualize_resolution_histogram(rows, args.output_viz_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
