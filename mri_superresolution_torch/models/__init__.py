"""Model registry: the four families of the JAX package (``unet``,
``unet_tpu``, ``edsr``, ``simple``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.models.edsr import EDSR
from mri_superresolution_torch.models.simple import SimpleSR
from mri_superresolution_torch.models.unet import (  # noqa: F401
    DoubleConv, Down, PixelShuffleUp, Up, UNetSuperRes, param_count)
from mri_superresolution_torch.models.unet_tpu import UNetSuperResTPU

# every family of the JAX package; checkpoint discovery must tell them apart
KNOWN_MODEL_TYPES = ("edsr", "simple", "unet", "unet_tpu")


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                generator: torch.Generator = None,
                remat: bool = False) -> nn.Module:
    """The ``cfg.model_type`` family with seeded initial weights (from
    ``generator``), computing in ``dtype`` on fp32 params; ``remat``
    recomputes the JAX package's remat blocks in the backward (a no-op
    for ``simple``)."""
    common = dict(in_channels=cfg.in_channels, out_channels=cfg.out_channels,
                  base_filters=cfg.base_filters, dtype=dtype,
                  generator=generator, remat=remat)
    if cfg.model_type == "unet":
        return UNetSuperRes(initial_alpha=cfg.initial_alpha, **common)
    if cfg.model_type == "unet_tpu":
        return UNetSuperResTPU(initial_alpha=cfg.initial_alpha, **common)
    if cfg.model_type == "edsr":
        return EDSR(num_blocks=cfg.num_blocks, **common)
    if cfg.model_type == "simple":
        return SimpleSR(**common)
    raise ValueError(f"Unknown model type: {cfg.model_type} "
                     f"(have {list(KNOWN_MODEL_TYPES)})")
