"""Device selection for the entry points: the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Raises when it is asked for and absent —
    an entry point never carries on on the CPU unless the caller said so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--cpu on the "
            "command line) to run on the CPU")
    return dev
