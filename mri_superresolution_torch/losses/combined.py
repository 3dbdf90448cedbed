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

Under data parallelism a rank holds part of the batch, and the SSIM clip
is the one term that is not linear in the batch: JAX clips the mean over
the global batch. ``ssim_reduce`` gives the loss the global weighted sum
and weight sum, so that every rank takes the clip decision of the global
mean (:func:`global_clip`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from mri_superresolution_torch.config import LossConfig
from mri_superresolution_torch.kernels import ssim_per_sample
from mri_superresolution_torch.models.vgg import VGG19Features, _call


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


# (local weighted SSIM sum, local weight sum) -> the global pair
SsimReduce = Callable[[torch.Tensor, torch.Tensor],
                      Tuple[torch.Tensor, torch.Tensor]]


def global_clip(mean: torch.Tensor, per_sample: torch.Tensor,
                sample_weights: Optional[torch.Tensor],
                reduce: SsimReduce) -> torch.Tensor:
    """The SSIM term's clip(mean, 0, 1) decided on the global batch.

    ``mean`` is this rank's weighted mean of ``per_sample``; ``reduce``
    sums the detached local (weighted sum, weight sum) over the ranks. The
    value is the global mean g clipped to [0, 1]; the gradient is the
    local mean's where 0 <= g <= 1 (``torch.clamp``'s own mask) and 0
    elsewhere, so that the ranks' gradients, each scaled by its share of
    the weights, add up to the gradient of the global clip. At a world of
    one g is ``mean`` to the bit, and value and gradient are
    ``mean.clamp(0, 1)``'s."""
    w = (torch.ones_like(per_sample) if sample_weights is None
         else sample_weights.float())
    num, den = reduce((per_sample.detach() * w).sum(), w.sum())
    g = num / den.clamp_min(1e-12)
    inside = (g >= 0.0) & (g <= 1.0)
    return torch.where(inside, mean + (g - mean.detach()), g.clamp(0.0, 1.0))


def compose_loss(cfg: LossConfig, out32, tgt32,
                 sample_weights, vgg: Optional[VGG19Features] = None,
                 remat: bool = False,
                 ssim_reduce: Optional[SsimReduce] = None, *,
                 per_sample_mean=_per_sample_mean,
                 weighted_mean=_weighted_mean, ssim_per_sample=None,
                 vgg_features=None, always_ssim_metric: bool = False,
                 each=_call) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The one copy of the CombinedLoss composition, on fp32 (B, H, W, 1)
    tensors. ``comps`` holds ``l1_loss``, ``ssim_loss``, ``ssim_metric``
    (the clipped SSIM) and ``perceptual_loss`` for the terms with a
    weight, as in the JAX package. ``remat`` recomputes the VGG19
    features of the output in the backward instead of keeping them: the
    JAX trainer's loss-graph checkpoint under ``--remat``. It is the only
    term with a tape to drop: L1 keeps none, and B2's backward already
    recomputes the SSIM maps inside its ``autograd.Function``. With
    ``ssim_reduce`` the SSIM clip is decided on the global batch
    (:func:`global_clip`).

    The JAX function's hooks replace its reductions and features; the
    defaults are the dense ones (B2 for the SSIM):

    - ``per_sample_mean(x) -> (B,)``: the mean over every other axis;
    - ``weighted_mean(per, w) -> scalar``: the weighted mean over the
      batch;
    - ``ssim_per_sample(a, b) -> (B,)``: the per-sample SSIM;
    - ``vgg_features(x)``: the VGG19 stack up to ``cfg.vgg_layer_idx``;
    - ``always_ssim_metric``: report the unclipped SSIM as
      ``ssim_metric`` when ``ssim_weight`` is 0;
    - ``each(fn, *xs)``: applies the composition's own elementwise steps;
      the row-sharded loss (``parallel/spatial.py``) passes its group's
      ``map``, and its tensors are then lists of row blocks."""
    if ssim_per_sample is None:
        def ssim_per_sample(a, b):
            return _ssim(cfg, a, b)
    if vgg_features is None:
        def vgg_features(x):
            if remat and torch.is_grad_enabled():
                return torch.utils.checkpoint.checkpoint(
                    vgg, x, use_reentrant=False, preserve_rng_state=False)
            return vgg(x)
    total = each(lambda o: torch.zeros((), dtype=torch.float32,
                                       device=o.device), out32)
    comps: Dict[str, torch.Tensor] = {}
    if cfg.l1_weight > 0:
        l1 = weighted_mean(per_sample_mean(each(
            lambda a, b: (a - b).abs(), out32, tgt32)), sample_weights)
        total = each(lambda t, v: t + cfg.l1_weight * v, total, l1)
        comps["l1_loss"] = l1
    if cfg.ssim_weight > 0 or always_ssim_metric:
        per = ssim_per_sample(out32, tgt32)
        ssim_raw = weighted_mean(per, sample_weights)
    if cfg.ssim_weight > 0:
        ssim_val = (each(lambda v: v.clamp(0.0, 1.0), ssim_raw)
                    if ssim_reduce is None else
                    global_clip(ssim_raw, per, sample_weights, ssim_reduce))
        # reference utils/losses.py:221
        ssim_l = each(lambda v: 1.0 - v, ssim_val)
        total = each(lambda t, v: t + cfg.ssim_weight * v, total, ssim_l)
        comps["ssim_loss"] = ssim_l
        comps["ssim_metric"] = ssim_val
    elif always_ssim_metric:
        comps["ssim_metric"] = ssim_raw
    if cfg.perceptual_weight > 0:
        fg = vgg_features(out32)
        with torch.no_grad():
            ft = vgg_features(tgt32)
        if cfg.perceptual_loss_type == "l1":
            per = per_sample_mean(each(lambda a, b: (a - b).abs(), fg, ft))
        elif cfg.perceptual_loss_type in ("l2", "mse"):
            per = per_sample_mean(each(lambda a, b: (a - b).square(), fg,
                                       ft))
        else:
            raise ValueError(
                f"Unsupported perceptual loss: {cfg.perceptual_loss_type}")
        perc = weighted_mean(per, sample_weights)
        total = each(lambda t, v: t + cfg.perceptual_weight * v, total, perc)
        comps["perceptual_loss"] = perc
    return total, comps


class CombinedLoss:
    """Callable loss bundle: ``loss(output, target, sample_weights) ->
    (total, comps)`` on (B, H, W, 1) tensors. ``vgg`` (a
    ``VGG19Features`` on the device of the tensors) is required iff
    ``perceptual_weight > 0``; ``remat`` recomputes its features of the
    output in the backward, and a call's ``ssim_reduce`` decides the SSIM
    clip on the global batch (:func:`compose_loss`)."""

    def __init__(self, cfg: LossConfig, vgg: Optional[VGG19Features] = None,
                 remat: bool = False):
        cfg.validate()
        if cfg.perceptual_weight > 0 and vgg is None:
            raise ValueError(
                "perceptual_weight > 0 requires VGG19 weights (pass vgg; "
                "see models/vgg.py for loading options)")
        self.cfg = cfg
        self.vgg = vgg
        self.remat = remat

    def ssim_per_sample(self, a: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
        """(B,) SSIM with the loss's window (kernel B2 on the card)."""
        return _ssim(self.cfg, a, b)

    def __call__(self, output: torch.Tensor, target: torch.Tensor,
                 sample_weights: Optional[torch.Tensor] = None,
                 ssim_reduce: Optional[SsimReduce] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return compose_loss(self.cfg, output.float(), target.float(),
                            sample_weights, self.vgg, self.remat,
                            ssim_reduce)
