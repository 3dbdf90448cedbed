"""Resolution analytics: native-resolution slice export and the
distribution of slice sizes.

The port's own copy of the JAX package's ``evalsuite/resolution.py``
(reference utils/visualise_res.py): each volume's middle slice as a
native-resolution PNG, a Width/Height/Count frequency table sorted by
count, and a bar histogram with a count-weighted scatter plot. The table
is a list of ``(width, height, count)`` rows, not a pandas DataFrame (the
port needs no pandas). Rows of equal count keep the order in which their
size first appeared; the JAX package sorts with pandas' quicksort, which
is not stable, so the order within such a tie is not part of the
contract.
"""

from __future__ import annotations

import os
from collections import Counter
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from mri_superresolution_torch.utils.figures import pyplot

COLUMNS = ("Width", "Height", "Count")


def extract_middle_slice(nifti_file: str,
                         output_dir: Optional[str] = None,
                         ) -> Optional[Tuple[int, int]]:
    """Save the middle axial slice at native resolution; returns (w, h),
    or None for a file that is not a 3D or 4D volume or cannot be read
    (parity: utils/visualise_res.py:32-124)."""
    from mri_superresolution_torch import native, nifti
    from mri_superresolution_torch.data.extraction import (
        generate_bids_identifier, to_uint8)

    try:
        data, _ = nifti.load(nifti_file)
        if data.ndim == 4:
            data = data[:, :, :, 0]
        if data.ndim != 3:
            print(f"Warning: {nifti_file} is {data.ndim}D, skipping")
            return None
        mid = data[:, :, data.shape[2] // 2].astype(np.float32)
        lo, hi = float(mid.min()), float(mid.max())
        norm = (mid - lo) / (hi - lo) if hi > lo else np.zeros_like(mid)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            name = generate_bids_identifier(nifti_file) + "_mid.png"
            native.imwrite_gray(os.path.join(output_dir, name),
                                to_uint8(norm))
        h, w = mid.shape
        return (w, h)
    except Exception as e:  # one bad file is reported and skipped
        print(f"Error: Could not process {nifti_file}: "
              f"{type(e).__name__} - {e}")
        return None


def analyze_resolutions(resolutions: List[Optional[Tuple[int, int]]]
                        ) -> List[Tuple[int, int, int]]:
    """(width, height, count) rows of the valid sizes, most frequent first
    (parity: utils/visualise_res.py:126-155)."""
    valid = [r for r in resolutions
             if r is not None and isinstance(r, tuple) and len(r) == 2]
    if not valid:
        print("Warning: No valid resolutions found to analyze.")
        return []
    rows = [(w, h, c) for (w, h), c in Counter(valid).items()]
    return sorted(rows, key=lambda r: -r[2])


def format_table(rows: List[Tuple[int, int, int]]) -> str:
    """The rows right-aligned under their column names, as pandas'
    ``to_string(index=False)`` prints the JAX package's table."""
    cells = [COLUMNS] + [tuple(str(v) for v in r) for r in rows]
    widths = [max(len(c[i]) for c in cells) for i in range(len(COLUMNS))]
    return "\n".join(" ".join(" " + v.rjust(n) for v, n in zip(c, widths))
                     for c in cells)


def visualize_resolution_histogram(rows: List[Tuple[int, int, int]],
                                   output_file: str =
                                   "spatial_resolution_histogram.png"
                                   ) -> bool:
    """Bar histogram of the 40 most frequent sizes, and a count-weighted
    scatter beside it (``<stem>_scatter.png``) (parity:
    utils/visualise_res.py:157-272). Returns whether they were written:
    not for an empty table, nor without matplotlib."""
    if not rows:
        print("Cannot generate visualization: Resolution DataFrame is empty.")
        return False
    plt = pyplot()
    if plt is None:
        return False
    bars_rows = sorted(rows, key=lambda r: -r[2])[:40]
    labels = [f"{int(w)}x{int(h)}" for w, h, _ in bars_rows]
    counts = [c for _, _, c in bars_rows]

    plt.figure(figsize=(max(14, len(bars_rows) * 0.5), 8))
    bars = plt.bar(labels, counts, color="steelblue", width=0.7,
                   edgecolor="black")
    for bar in bars:
        h = bar.get_height()
        plt.text(bar.get_x() + bar.get_width() / 2, h + 0.5, str(int(h)),
                 ha="center", va="bottom", fontweight="bold", fontsize=9)
    plt.title("Histogram of Original Spatial Resolutions (Width x Height)",
              fontsize=16)
    plt.xlabel("Resolution", fontsize=14)
    plt.ylabel("Frequency", fontsize=14)
    plt.xticks(rotation=60, ha="right", fontsize=10)
    plt.grid(axis="y", linestyle="--", alpha=0.7)
    plt.tight_layout()
    plt.savefig(output_file, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Histogram visualization saved to '{output_file}'")

    widths = [w for w, _, _ in rows]
    heights = [h for _, h, _ in rows]
    all_counts = [c for _, _, c in rows]
    plt.figure(figsize=(10, 8))
    sc = plt.scatter(widths, heights, s=[c * 20 for c in all_counts],
                     alpha=0.7, c=all_counts, cmap="viridis",
                     edgecolors="black")
    plt.colorbar(sc).set_label("Frequency (Count)", fontsize=12)
    plt.title("Distribution of Spatial Resolutions (Width vs Height)",
              fontsize=16)
    plt.xlabel("Width (pixels)", fontsize=14)
    plt.ylabel("Height (pixels)", fontsize=14)
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.tight_layout()
    scatter_output = str(Path(output_file).with_name(
        Path(output_file).stem + "_scatter.png"))
    plt.savefig(scatter_output, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"Scatter visualization saved to '{scatter_output}'")
    return True
