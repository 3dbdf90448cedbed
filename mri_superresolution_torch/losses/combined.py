"""Composite training loss: L1 + SSIM (+ VGG perceptual, not ported yet).

An own copy of the JAX package's ``losses/combined.py`` (reference
``CombinedLoss``, utils/losses.py:153-240): ``total = l1_w * L1 + ssim_w *
(1 - clip(SSIM, 0, 1)) + perc_w * Perc`` with ``l1_w = 1 - ssim_w -
perc_w``, SSIM window 11 / sigma 1.5 / val_range 1.0, every term a mean
over the batch weighted by per-sample weights (zeros mark the padding rows
of a final partial batch). The SSIM term is kernel B2
(``kernels.ssim_per_sample``), differentiable on the card. The perceptual
term needs VGG19 and comes with ROADMAP A5; ``perceptual_weight > 0``
raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mri_superresolution_torch.config import LossConfig
from mri_superresolution_torch.kernels import ssim_per_sample


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


def _check_ported(cfg: LossConfig) -> None:
    if cfg.perceptual_weight > 0:
        raise NotImplementedError(
            "perceptual_weight > 0 needs the VGG19 perceptual loss, which "
            "the port does not have yet (ROADMAP A5, models/vgg.py)")


def _ssim(cfg: LossConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ssim_per_sample(a.contiguous(), b.contiguous(), cfg.window_size,
                           cfg.sigma, cfg.val_range)


def compose_loss(cfg: LossConfig, out32: torch.Tensor, tgt32: torch.Tensor,
                 sample_weights: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The CombinedLoss composition on fp32 (B, H, W, 1) tensors. ``comps``
    holds ``l1_loss``, ``ssim_loss`` and ``ssim_metric`` (the clipped
    SSIM), as in the JAX package."""
    _check_ported(cfg)
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
    return total, comps


class CombinedLoss:
    """Callable loss bundle: ``loss(output, target, sample_weights) ->
    (total, comps)`` on (B, H, W, 1) tensors."""

    def __init__(self, cfg: LossConfig):
        cfg.validate()
        _check_ported(cfg)
        self.cfg = cfg

    def ssim_per_sample(self, a: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
        """(B,) SSIM with the loss's window (kernel B2 on the card)."""
        return _ssim(self.cfg, a, b)

    def __call__(self, output: torch.Tensor, target: torch.Tensor,
                 sample_weights: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return compose_loss(self.cfg, output.float(), target.float(),
                            sample_weights)
