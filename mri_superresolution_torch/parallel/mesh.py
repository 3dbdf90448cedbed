"""Device pool, batch rows and ZeRO-1 layout of data-parallel work.

An own copy of the JAX package's ``parallel/mesh.py`` rules for the port.
JAX lays a 1-D ``('data',)`` mesh over its devices and lets GSPMD place
the batch and insert the collectives; here the same decisions are plain
functions that the trainer (one process a rank) and the inference engine
(one process, a model copy a device) apply themselves:

- :func:`device_pool`: which devices the work spans, capped as
  ``make_mesh`` caps;
- :func:`rank_rows`: which rows of a global batch one rank holds, in the
  order GSPMD spreads JAX's microbatches over the mesh;
- :func:`zero1_layout`: along which axis a ZeRO-1 optimizer shards a
  tensor's moments (``zero1_shardings``' rule);
- :func:`pad_batch_to_devices`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def device_pool(num_devices: int = 0,
                devices: Optional[Sequence] = None) -> list:
    """The first ``min(num_devices, len(pool))`` devices of the pool, 0
    meaning all of it. The pool is ``devices`` when given (the CPU is used
    only so), else every visible CUDA device; with none visible it raises,
    as an entry point never carries on on the CPU unless asked."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=[torch.device("
                "'cpu')] (--cpu on the command line) to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    pool = [torch.device(d) for d in devices]
    if not pool:
        raise ValueError("devices must name at least one device")
    if num_devices and num_devices > 0:
        pool = pool[:num_devices]
    return pool


def zero1_layout(shape: Tuple[int, ...], n: int) -> Optional[int]:
    """The axis along which a ZeRO-1 optimizer shards a tensor of
    ``shape`` over ``n`` ranks: the largest axis that ``n`` divides (the
    first of equal ones), None (replicate) for a scalar or when no axis
    divides."""
    shape = tuple(int(s) for s in shape)
    for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if shape[ax] >= n and shape[ax] % n == 0:
            return ax
    return None


def pad_batch_to_devices(batch_size: int, n_devices: int) -> int:
    """Smallest batch size >= batch_size divisible by the device count."""
    return int(-(-batch_size // n_devices) * n_devices)


def rank_rows(batch_size: int, world: int, rank: int,
              grad_accum: int = 1) -> np.ndarray:
    """The rows of a global batch that rank ``rank`` of ``world`` holds,
    in its order. JAX splits the batch into ``grad_accum`` contiguous
    microbatches first and GSPMD spreads each over the mesh, so the rank
    holds the ``rank``-th of the world's equal parts of each microbatch:
    its ``grad_accum`` equal chunks are its parts of microbatches 0, 1,
    ... in turn. ``batch_size`` must divide by ``world * grad_accum``."""
    if batch_size % (world * grad_accum):
        raise ValueError(f"batch_size {batch_size} does not divide into "
                         f"{world} ranks x {grad_accum} microbatches")
    micro = batch_size // grad_accum
    part = micro // world
    return np.concatenate([np.arange(j * micro + rank * part,
                                     j * micro + (rank + 1) * part)
                           for j in range(grad_accum)])
