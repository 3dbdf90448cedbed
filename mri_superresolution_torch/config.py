"""Typed configs of the serving slice.

An own copy of ``ModelConfig`` and ``InferConfig`` from the JAX package,
limited to the fields this package reads. ``model_config_from_dict`` reads
the ``config.model`` block of a checkpoint's JSON sidecar and ignores keys
this copy does not know (``num_blocks``, ``in_channels`` ...).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ModelConfig:
    """U-Net hyperparameters (reference models/unet_model.py:116-129)."""
    model_type: str = "unet"
    base_filters: int = 32
    initial_alpha: float = 0.0  # percentage 0-100, normalized /100 internally
    icnr_init: bool = False


@dataclass
class InferConfig:
    """Inference config (reference scripts/infer.py:452-486)."""
    model: ModelConfig = field(default_factory=ModelConfig)
    checkpoint_dir: str = "./checkpoints"
    checkpoint_path: Optional[str] = None
    bf16: bool = True
    # Spatial shape bucket: inputs are zero-padded to a multiple of this
    # before the forward. 1 = native sizes (GroupNorm-exact, default).
    bucket: int = 1
    # "int8": post-training-quantized serving (models/quant_forward.py),
    # self-calibrated on the first content-rich slices; "none": bf16.
    quant: str = "none"
    # streaming self-calibration length in real slices
    quant_calib_slices: int = 8
    # JSON sidecar of frozen int8 scales: loaded if it exists, else
    # written when calibration freezes
    quant_calib_path: Optional[str] = None


def model_config_from_dict(data: dict) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in data.items() if k in names})
