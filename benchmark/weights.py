"""Seeded weights of a configuration, made on the device in one draw.

A configuration's reference (``configs/<name>.py``) lists its parameters
as (name, shape, mean, std). One ``torch.randn`` of their total size on
the device, from a generator seeded by ``--seed``, is scaled and shifted
by per-element vectors and cut into the named fp32 tensors, the type the
program keeps its master weights in. Both the program and the reference
take these same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from benchmark import traffic

Spec = List[Tuple[str, Tuple[int, ...], float, float]]


def make(spec: Spec, seed: int, device) -> Dict[str, "torch.Tensor"]:
    import torch
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    mean = np.repeat(np.array([m for _, _, m, _ in spec], np.float32), sizes)
    std = np.repeat(np.array([s for _, _, _, s in spec], np.float32), sizes)
    g = traffic.torch_generator(seed, device, 5)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat = flat * torch.from_numpy(std).to(device) + \
        torch.from_numpy(mean).to(device)
    out, at = {}, 0
    for (name, shape, _, _), n in zip(spec, sizes):
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out
