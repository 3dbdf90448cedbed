"""Model registry: the families of ``models/families.py``, the JAX
package's four and the port's own ``swinir``."""

from __future__ import annotations

import torch
import torch.nn as nn

from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.models.edsr import EDSR  # noqa: F401
from mri_superresolution_torch.models.families import (  # noqa: F401
    FAMILIES, family)
from mri_superresolution_torch.models.simple import SimpleSR  # noqa: F401
from mri_superresolution_torch.models.swinir import SwinIR  # noqa: F401
from mri_superresolution_torch.models.unet import (  # noqa: F401
    DoubleConv, Down, PixelShuffleUp, Up, UNetSuperRes, param_count)
from mri_superresolution_torch.models.unet_tpu import (  # noqa: F401
    UNetSuperResTPU)


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                generator: torch.Generator = None,
                remat: bool = False) -> nn.Module:
    """The ``cfg.model_type`` family with seeded initial weights (from
    ``generator``), computing in ``dtype`` on fp32 params; ``remat``
    recomputes the JAX package's remat blocks in the backward (a no-op
    for ``simple`` and ``swinir``). An unknown type raises ValueError."""
    return family(cfg.model_type).build(cfg, dtype, generator, remat)
