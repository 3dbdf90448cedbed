"""Typed configs of the port.

An own copy of the JAX package's ``config.py``: ``ModelConfig`` (with
every field of the JAX one, so that a checkpoint's JSON sidecar has the
same ``config`` block whichever package wrote it), and ``LossConfig``,
``AugmentConfig``, ``TrainConfig``, ``ExtractConfig`` and ``InferConfig``
whole, with the same names, defaults and meanings.
``model_config_from_dict`` and ``train_config_from_dict`` read a
sidecar's blocks and ignore keys this copy does not know.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    """Model hyperparameters: the U-Net's (reference models/unet_model.py:
    116-129), the other families' beside them."""
    model_type: str = "unet"
    in_channels: int = 1
    out_channels: int = 1
    base_filters: int = 32
    initial_alpha: float = 0.0  # percentage 0-100, normalized /100 internally
    num_blocks: int = 8         # trunk depth (edsr), residual groups (swinir)
    # swinir only (base_filters is its embed_dim): the published classical
    # 2x widths of Liang et al. 2021
    swin_depth: int = 6         # Swin blocks a residual group
    swin_heads: int = 6
    window_size: int = 8        # attention windows; odd blocks shift by half
    mlp_ratio: float = 2.0
    num_feat: int = 64          # channels of the upsampling tail


@dataclass
class LossConfig:
    """CombinedLoss weights (reference utils/losses.py:153-198).
    l1_weight = 1 - ssim_weight - perceptual_weight, derived."""
    ssim_weight: float = 0.3
    perceptual_weight: float = 0.0
    vgg_layer_idx: int = 35        # relu5_4 features in VGG19
    perceptual_loss_type: str = "l1"
    window_size: int = 11
    sigma: float = 1.5
    val_range: float = 1.0

    @property
    def l1_weight(self) -> float:
        return 1.0 - self.ssim_weight - self.perceptual_weight

    def validate(self) -> None:
        if not 0 <= self.ssim_weight <= 1:
            raise ValueError("ssim_weight must be between 0 and 1")
        if not 0 <= self.perceptual_weight <= 1:
            raise ValueError("perceptual_weight must be between 0 and 1")
        if self.ssim_weight + self.perceptual_weight > 1:
            raise ValueError("Sum of ssim_weight and perceptual_weight "
                             "cannot exceed 1")


@dataclass
class AugmentConfig:
    """Paired augmentation defaults (reference utils/dataset.py:71-81)."""
    enabled: bool = False
    flip_prob: float = 0.5
    rotate_prob: float = 0.5
    rotate_range: Tuple[float, float] = (-5.0, 5.0)
    brightness_prob: float = 0.3
    brightness_range: Tuple[float, float] = (0.9, 1.1)
    contrast_prob: float = 0.3
    contrast_range: Tuple[float, float] = (0.9, 1.1)
    noise_prob: float = 0.2      # applied to the LR image only
    noise_std: float = 0.01


@dataclass
class TrainConfig:
    """Training loop config (reference scripts/train.py:486-548 defaults).
    The meaning of each field is the JAX package's (its ``config.py``)."""
    full_res_dir: str = ""
    low_res_dir: str = ""
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    batch_size: int = 8
    epochs: int = 100
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    validation_split: float = 0.2
    split_by_subject: bool = False  # subject-level split (no leakage)
    patience: int = 10
    seed: int = 42
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    use_tensorboard: bool = False
    bf16: bool = True            # bfloat16 compute on fp32 master weights
    num_data_devices: int = 0    # devices of the data mesh (ROADMAP A14)
    resume: bool = False
    vgg_weights: Optional[str] = None  # VGG19 .npz for the perceptual loss
    profile_dir: Optional[str] = None  # torch.profiler trace of one epoch
    # "off": decode the whole dataset up front; "on": per-batch decode with
    # a background prefetch; "auto": stream past streaming_threshold_mb
    streaming: str = "auto"
    streaming_prefetch: int = 2
    streaming_threshold_mb: int = 2048
    spatial_shards: int = 1      # row sharding over devices (A14)
    remat: bool = False          # recompute the forward in the backward
    # sequential microbatches a step, fp32 gradients recombined exactly
    grad_accum: int = 1
    # Polyak average of the weights after each step (0 = off); validation,
    # best-model selection and the checkpoint's params use it
    ema_decay: float = 0.0
    opt_shard: bool = False      # ZeRO-1 optimizer-state sharding (A14)
    qat: bool = False            # quantization-aware training (A11)
    qat_decay: float = 0.98
    # every N optimizer steps a step_model_<type> checkpoint with the
    # epoch's batch cursor, for a bit-identical mid-epoch --resume
    save_every_steps: int = 0


@dataclass
class ExtractConfig:
    """Paired-slice extraction config, the defaults of the reference's
    scripts/extract_paired_slices.py:98-122 (``cli/extract.py``)."""
    datasets_dir: str = "./datasets"
    hr_output_dir: str = "./training_data"
    lr_output_dir: str = "./training_data_1.5T"
    n_slices: int = 10
    lower_percent: float = 0.2
    upper_percent: float = 0.8
    target_size: Tuple[int, int] = (256, 256)  # (width, height)
    noise_std: float = 5.0
    kspace_crop_factor: float = 0.5
    seed: int = 0


@dataclass
class InferConfig:
    """Inference config (reference scripts/infer.py:452-486), with the JAX
    package's fields in its order."""
    model: ModelConfig = field(default_factory=ModelConfig)
    checkpoint_dir: str = "./checkpoints"
    checkpoint_path: Optional[str] = None
    bf16: bool = True
    batch_size: int = 8          # slices a forward, for volume serving
    # Spatial shape bucket: inputs are zero-padded to a multiple of this
    # before the forward. 1 = native sizes (GroupNorm-exact, default).
    bucket: int = 1
    # row sharding over devices (ROADMAP A14)
    spatial_shards: int = 1
    # "int8": post-training-quantized serving (models/quant_forward.py),
    # self-calibrated on the first content-rich slices; "none": bf16.
    quant: str = "none"
    # streaming self-calibration length in real slices
    quant_calib_slices: int = 8
    # batches whose fraction of pixels above FOREGROUND_INTENSITY is below
    # this serve on the bf16 model instead of int8; 0 disables the routing
    quant_min_foreground: float = 0.05
    # JSON sidecar of frozen int8 scales: loaded if it exists, else
    # written when calibration freezes
    quant_calib_path: Optional[str] = None
    # test-time augmentation: the mean over the dihedral transforms (8 for
    # square inputs, 4 otherwise)
    tta: bool = False
    # raw uint8/uint16/int16/float inputs, normalized per slice on the card
    normalize_inputs: bool = False
    # output coding: "float32", or "uint8"/"int16" packed on the card
    out_dtype: str = "float32"
    # batches arrive (N, w, h), the free C-order view of a NIfTI volume's
    # F-order buffer, and return (N, 2w, 2h); needs normalize_inputs
    transpose_io: bool = False


# ModelConfig's fields that only swinir reads. A checkpoint's sidecar
# leaves them out: its weights carry every Swin width in their shapes
# (utils/weights.swinir_widths), and the JAX package's ModelConfig has none.
SWIN_FIELDS = ("swin_depth", "swin_heads", "window_size", "mlp_ratio",
               "num_feat")


def to_dict(cfg) -> dict:
    """``cfg`` (a config, or one holding a ``model``) as a checkpoint
    sidecar's ``config`` block, without :data:`SWIN_FIELDS`."""
    d = dataclasses.asdict(cfg)
    for m in (d, d.get("model")):
        if isinstance(m, dict):
            for k in SWIN_FIELDS:
                m.pop(k, None)
    return d


_SUB = {"model": ModelConfig, "loss": LossConfig, "augment": AugmentConfig}


def _build(cls, data: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in names:
            continue
        if isinstance(v, dict) and k in _SUB:
            kwargs[k] = _build(_SUB[k], v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def model_config_from_dict(data: dict) -> ModelConfig:
    return _build(ModelConfig, data)


def train_config_from_dict(data: dict) -> TrainConfig:
    return _build(TrainConfig, data)
