"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

Each wrapper takes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version in the same module, and counts its kernel launches in
``<wrapper>.launches`` (``group_norm_leaky.onepass_launches`` and
``group_norm_leaky_backward.onepass_launches`` count their one-pass routes
apart, ``leaky_quantize.stream_launches`` its stream route).
:func:`launch_counts` covers every wrapper, which the card tests compare
whole.
Nothing here builds or imports anything at import time:
``_build.library()`` compiles at first use.
"""

from mri_superresolution_torch.kernels.bias_epilogue import (  # noqa: F401
    bias_epilogue)
from mri_superresolution_torch.kernels.conv3x3 import conv3x3  # noqa: F401
from mri_superresolution_torch.kernels.groupnorm import (  # noqa: F401
    gn_quantize, group_norm_leaky, group_norm_leaky_backward)
from mri_superresolution_torch.kernels.leaky_quantize import (  # noqa: F401
    leaky_quantize)
from mri_superresolution_torch.kernels.padded_layer_norm import (  # noqa: F401
    padded_layer_norm)
from mri_superresolution_torch.kernels.roll_probe import (  # noqa: F401
    roll32, roll_copy, taps3)
from mri_superresolution_torch.kernels.ssim import ssim_per_sample  # noqa: F401
from mri_superresolution_torch.kernels.swin_mlp import swin_mlp  # noqa: F401
from mri_superresolution_torch.kernels.window_attention import (  # noqa: F401
    window_attention)

WRAPPERS = (group_norm_leaky, group_norm_leaky_backward, conv3x3,
            ssim_per_sample, leaky_quantize, gn_quantize, roll_copy, roll32,
            taps3, bias_epilogue, window_attention, padded_layer_norm,
            swin_mlp)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    group_norm_leaky.onepass_launches = 0
    group_norm_leaky_backward.onepass_launches = 0
    leaky_quantize.stream_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
