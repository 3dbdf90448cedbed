"""Composite training loss: L1 + SSIM + optional VGG19 perceptual.

An own copy of the JAX package's ``losses/combined.py`` (reference
``CombinedLoss``, utils/losses.py:153-240): ``total = l1_w * L1 + ssim_w *
(1 - clip(SSIM, 0, 1)) + perc_w * Perc`` with ``l1_w = 1 - ssim_w -
perc_w``, SSIM window 11 / sigma 1.5 / val_range 1.0, every term a mean
over the batch weighted by per-sample weights (zeros mark the padding rows
of a final partial batch). The SSIM term is kernel B2
(``kernels.ssim_per_sample``), differentiable on the card. The perceptual
term runs output and target through VGG19 (``models/vgg.py``, cuDNN's
convs in fp32, TF32 on the card unless ``torch.backends.cudnn.allow_tf32``
is off), the target's features without a gradient (the reference's
stop-gradient, utils/losses.py:146-147), and takes the per-sample mean of
|dF| (``l1``) or dF^2 (``l2``/``mse``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mri_superresolution_torch.config import LossConfig
from mri_superresolution_torch.kernels import ssim_per_sample
from mri_superresolution_torch.models.vgg import VGG19Features


def _weighted_mean(per_sample: torch.Tensor,
                   sample_weights: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_weights is None:
        return per_sample.mean()
    w = sample_weights.float()
    return (per_sample * w).sum() / w.sum().clamp_min(1e-12)


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def l1_loss(a: torch.Tensor, b: torch.Tensor,
            sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _weighted_mean(_per_sample_mean((a.float() - b.float()).abs()),
                          sample_weights)


def _ssim(cfg: LossConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ssim_per_sample(a.contiguous(), b.contiguous(), cfg.window_size,
                           cfg.sigma, cfg.val_range)


def compose_loss(cfg: LossConfig, out32: torch.Tensor, tgt32: torch.Tensor,
                 sample_weights: Optional[torch.Tensor],
                 vgg: Optional[VGG19Features] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The CombinedLoss composition on fp32 (B, H, W, 1) tensors. ``comps``
    holds ``l1_loss``, ``ssim_loss``, ``ssim_metric`` (the clipped SSIM)
    and ``perceptual_loss`` for the terms with a weight, as in the JAX
    package."""
    total = torch.zeros((), dtype=torch.float32, device=out32.device)
    comps: Dict[str, torch.Tensor] = {}
    if cfg.l1_weight > 0:
        l1 = l1_loss(out32, tgt32, sample_weights)
        total = total + cfg.l1_weight * l1
        comps["l1_loss"] = l1
    if cfg.ssim_weight > 0:
        ssim_val = _weighted_mean(_ssim(cfg, out32, tgt32),
                                  sample_weights).clamp(0.0, 1.0)
        ssim_l = 1.0 - ssim_val               # reference utils/losses.py:221
        total = total + cfg.ssim_weight * ssim_l
        comps["ssim_loss"] = ssim_l
        comps["ssim_metric"] = ssim_val
    if cfg.perceptual_weight > 0:
        fg = vgg(out32)
        with torch.no_grad():
            ft = vgg(tgt32)
        if cfg.perceptual_loss_type == "l1":
            per = _per_sample_mean((fg - ft).abs())
        elif cfg.perceptual_loss_type in ("l2", "mse"):
            per = _per_sample_mean((fg - ft).square())
        else:
            raise ValueError(
                f"Unsupported perceptual loss: {cfg.perceptual_loss_type}")
        perc = _weighted_mean(per, sample_weights)
        total = total + cfg.perceptual_weight * perc
        comps["perceptual_loss"] = perc
    return total, comps


class CombinedLoss:
    """Callable loss bundle: ``loss(output, target, sample_weights) ->
    (total, comps)`` on (B, H, W, 1) tensors. ``vgg`` (a
    ``VGG19Features`` on the device of the tensors) is required iff
    ``perceptual_weight > 0``."""

    def __init__(self, cfg: LossConfig, vgg: Optional[VGG19Features] = None):
        cfg.validate()
        if cfg.perceptual_weight > 0 and vgg is None:
            raise ValueError(
                "perceptual_weight > 0 requires VGG19 weights (pass vgg; "
                "see models/vgg.py for loading options)")
        self.cfg = cfg
        self.vgg = vgg

    def ssim_per_sample(self, a: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
        """(B,) SSIM with the loss's window (kernel B2 on the card)."""
        return _ssim(self.cfg, a, b)

    def __call__(self, output: torch.Tensor, target: torch.Tensor,
                 sample_weights: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return compose_loss(self.cfg, output.float(), target.float(),
                            sample_weights, self.vgg)
