"""Seeded synthetic MRI-like slices for smoke runs, probes and tests."""

from __future__ import annotations

import numpy as np


def phantom_batch(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Smooth (n, size, size) float32 slices in [0, 1], six random ellipses
    each. A generator with the same seed at twice the size draws the same
    ellipses, which makes a 2x ground truth."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size - 0.5
    out = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(6):
            cy, cx = rng.uniform(-0.3, 0.3, 2)
            ry, rx = rng.uniform(0.05, 0.35, 2)
            out[i] += rng.uniform(0.1, 0.5) * (
                ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0)
    return np.clip(out, 0.0, 1.0)
