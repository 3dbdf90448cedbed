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


def pool_args(num_devices: int, cpu: bool) -> dict:
    """The engine's device-pool arguments for a CLI's ``--num_devices``
    and ``--cpu``: that many GPUs (0 = every visible one), or on the CPU
    that many CPU devices (0 = 1), the counterpart of the JAX package's
    host device count."""
    if cpu:
        return {"devices": [torch.device("cpu")] * max(1, num_devices)}
    return {"num_devices": num_devices}
