"""Data parallelism of the port: the device pool and ZeRO-1 layout
(``mesh.py``), and process groups over ``torch.distributed``
(``multihost.py``, imported by name: it is also the rank processes' entry
point, ``python -m mri_superresolution_torch.parallel.multihost``)."""

from mri_superresolution_torch.parallel.mesh import (  # noqa: F401
    device_pool, pad_batch_to_devices, rank_rows, zero1_layout)
