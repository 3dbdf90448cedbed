"""Parallelism of the port: the device pool and ZeRO-1 layout of data
parallelism (``mesh.py``), row-sharded (spatial) serving forwards and
training loss (``spatial.py``), and process groups over
``torch.distributed`` (``multihost.py``, imported by name: it is also the
rank processes' entry point, ``python -m
mri_superresolution_torch.parallel.multihost``)."""

from mri_superresolution_torch.parallel.mesh import (  # noqa: F401
    device_pool, pad_batch_to_devices, rank_rows, zero1_layout)
from mri_superresolution_torch.parallel.spatial import (  # noqa: F401
    RankMesh, build_spatial_calib_forward_raw, build_spatial_forward,
    build_spatial_int8_forward_raw, build_spatial_loss, make_spatial_mesh)
