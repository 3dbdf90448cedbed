"""Dihedral test-time-augmentation ensemble.

The port's own copy of the JAX package's ``ops/tta.py``. The serving
engine's ``tta`` averages the model over the dihedral transforms of its
input, mean_t t^-1(upscale(t(x))): the 8 symmetries of the square when
h == w, the 4 axis flips otherwise.

JAX traces the ensemble into one program (a ``lax.fori_loop`` over the
members, ``lax.switch`` for the inverses). In eager PyTorch a Python loop
over the members is its counterpart, and it keeps every rule of the traced
version:
- one member's forward is alive at a time, accumulated in fp32, so the
  peak is one forward plus one (N, 2h, 2w, C) accumulator;
- each member is transformed first and then zero-padded to
  ``bucket_fn(h, w)`` (a transform of a padded buffer would put the pad on
  the wrong side and move the pooling grid);
- each output is cropped to (2h, 2w) before its inverse;
- the sum is divided by the member count; any packing comes after the
  mean, in the caller.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["dihedral_pairs", "tta_ensemble"]


def _flip(x, axes):
    if isinstance(x, torch.Tensor):
        return x.flip(axes)
    return np.flip(x, axes)


def _identity(x):
    return x


def _flip_h(x):
    return _flip(x, (1,))


def _flip_w(x):
    return _flip(x, (2,))


def _flip_hw(x):
    return _flip(x, (1, 2))


def _transpose(x):
    # the spatial axes only; works for NHWC and channel-less NHW
    return x.swapaxes(1, 2)


def dihedral_pairs(square: bool):
    """(transform, inverse) pairs on batched spatial arrays (numpy arrays
    or tensors), in the JAX package's member order.

    The 4 axis flips are involutions (inverse == transform). With
    ``square`` the 4 transpose-composed elements follow: t = f . T has
    t^-1 = T . f. The first pair is always the identity: the engine's int8
    calibration keys on it."""
    pairs = [(_identity, _identity), (_flip_h, _flip_h),
             (_flip_w, _flip_w), (_flip_hw, _flip_hw)]
    if square:
        pairs += [(lambda x, f=f: f(_transpose(x)),
                   lambda y, f=f: _transpose(f(y)))
                  for f, _ in list(pairs)]
    return pairs


def tta_ensemble(forward: Callable, x: torch.Tensor,
                 bucket_fn: Callable = None) -> torch.Tensor:
    """The dihedral mean of ``forward`` over the (N, H, W, C) batch ``x``,
    (N, 2H, 2W, C) fp32.

    ``forward`` maps an (N, bh, bw, C) tensor to (N, 2bh, 2bw, C) and
    includes its own output clip. ``bucket_fn(h, w) -> (bh, bw)`` (the
    engine passes ``_bucket_hw``) sets the shape the forward runs at: each
    transformed member is zero-padded to it and its output cropped back to
    (2h, 2w) before the inverse. The members run one after another."""
    n, h, w, c = x.shape
    bh, bw = bucket_fn(h, w) if bucket_fn is not None else (h, w)
    pairs = dihedral_pairs(square=(h == w))
    acc = torch.zeros((n, 2 * h, 2 * w, c), dtype=torch.float32,
                      device=x.device)
    for t, inv in pairs:
        xi = t(x)
        if (bh, bw) != (h, w):
            xi = F.pad(xi, (0, 0, 0, bw - w, 0, bh - h))
        y = forward(xi.contiguous()).float()
        acc += inv(y[:, :2 * h, :2 * w])
    return acc / len(pairs)
