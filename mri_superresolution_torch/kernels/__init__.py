"""Hand-written CUDA kernels of the serving path (sources in ``csrc/``).

Each wrapper takes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version in the same module, and counts its kernel launches in
``<wrapper>.launches``. Nothing here builds or imports anything at import
time: ``_build.library()`` compiles at first use.
"""

from mri_superresolution_torch.kernels.conv3x3 import conv3x3  # noqa: F401
from mri_superresolution_torch.kernels.groupnorm import (  # noqa: F401
    group_norm_leaky)
from mri_superresolution_torch.kernels.ssim import ssim_per_sample  # noqa: F401

WRAPPERS = (group_norm_leaky, conv3x3, ssim_per_sample)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
