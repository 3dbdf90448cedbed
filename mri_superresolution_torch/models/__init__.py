"""Model registry. This slice serves the ``unet`` family; the others come
with ROADMAP item A8."""

from __future__ import annotations

import torch

from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.models.unet import (  # noqa: F401
    DoubleConv, Down, PixelShuffleUp, Up, UNetSuperRes, param_count)

# every family of the JAX package; checkpoint discovery must tell them apart
KNOWN_MODEL_TYPES = ("edsr", "simple", "unet", "unet_tpu")


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                generator: torch.Generator = None) -> UNetSuperRes:
    if cfg.model_type == "unet":
        return UNetSuperRes(in_channels=cfg.in_channels,
                            out_channels=cfg.out_channels,
                            base_filters=cfg.base_filters,
                            initial_alpha=cfg.initial_alpha, dtype=dtype,
                            generator=generator)
    if cfg.model_type in KNOWN_MODEL_TYPES:
        raise NotImplementedError(
            f"model type {cfg.model_type!r} is not ported yet (ROADMAP A8)")
    raise ValueError(f"Unknown model type: {cfg.model_type} "
                     f"(have {list(KNOWN_MODEL_TYPES)})")
