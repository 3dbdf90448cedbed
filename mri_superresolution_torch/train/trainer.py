"""Trainer of the model zoo: bf16 compute on fp32 master weights, on one
device or data-parallel over ranks.

An own copy of the JAX package's ``train/trainer.py``.
Reference behaviour reproduced (scripts/train.py:142-484): Adam (lr 1e-4,
weight decay 1e-5 as L2 added to the gradient before the moments),
ReduceLROnPlateau (factor .5, patience patience//2), a seeded train/val
split, the per-batch SSIM metric, the JSON-line protocol (``params``,
``batch_update``, ``epoch_summary``), best/final checkpoints, early
stopping, optional TensorBoard and periodic sample grids.

Every family of ``models/families.py`` trains, with the full
``CombinedLoss``: L1, SSIM and the VGG19 perceptual term
(``--vgg_weights``, an ``.npz`` in the JAX package's format; without it
seeded random VGG weights, with a warning, as the JAX trainer does). On
the card every GroupNorm+LeakyReLU runs kernel B1 forward and backward,
the unet's two narrow 3x3 convs kernel B3, and the loss's SSIM kernel B2
(``kernels/``: each wrapper is an ``autograd.Function`` where autograd
needs it). Augmentation runs on the device from a ``torch.Generator``
seeded from (seed, epoch, batch), as the JAX trainer folds its key, so a
resumed run replays the same draws. Checkpoints are the JAX package's
format (``train/checkpoint.py``), the optimizer state included, so runs
resume across packages.

``--qat`` (quantization-aware training) trains through the int8 serving
arithmetic simulated in float (``models/quant_forward.
build_fakequant_forward``): a running per-site activation range
(``TrainState.qat_amax``) feeds the quantizers and follows each batch's
statistic as an EMA (``qat_decay``); validation, the plateau, early
stopping and best-model selection score that forward; every checkpoint
stores the range and writes the frozen scales beside it
(``<base>.calib.json``), which ``load_engine`` serves int8 with.

``--remat`` builds the model with the JAX package's remat blocks
recomputed in the backward (``models/unet.segment``) and checkpoints the
perceptual term's VGG19 features (``losses/combined.compose_loss``); the
update is the same bits as without it. Under ``--qat`` the fake-quant
forward is functional, so only the loss-side checkpoint applies, as in
JAX. ``--profile_dir`` traces one epoch with ``torch.profiler`` (CPU and
CUDA activities) into a Chrome trace there, the epoch the JAX trainer
traces: ``min(start_epoch + 1, epochs - 1)``, its validation included;
each step's ``train.step``, ``train.forward``, ``train.loss``,
``train.backward`` and ``train.update`` spans (``utils/spans.py``) are
among its ranges.

Data parallelism (the JAX trainer's mesh and ``--multihost``): when this
process is a rank of a process group (``parallel/multihost.py``; the
train CLI's ``--num_devices`` and ``--multihost`` make one), every rank
derives the global batch order from (seed, epoch) as one process does and
takes its rows (``parallel.rank_rows``: its part of each microbatch, as
GSPMD spreads JAX's), draws the augmentation for the global batch and
keeps its rows' draws, and runs :func:`loss_and_grads` on its rows with
the SSIM clip decided on the global (micro)batch. The fp32 gradient sums
and weight sums are all-reduced as one bucket (the model is not wrapped
in DDP: the step takes its gradients with ``torch.autograd.grad``); QAT's
batch statistic is a global max and its foreground flag a global or;
validation sums are all-reduced, so the plateau, early stopping and the
best model decide the same on every rank; the EMA stays rank-local (the
ranks' parameters are the same bits, so their EMAs are too).
``--opt_shard`` shards Adam's moments over the ranks (``train/zero1.py``,
ZeRO-1) with the replicated update's bits. Rank 0 alone speaks the stdout
protocol and writes checkpoints, sidecars, figures, traces and
``training.log``; rank r logs to ``training.p{r}.log``. Without a process
group the path is the single-device one, unchanged.

Spatial sharding (``--spatial_shards S``, the JAX trainer's (data, space)
mesh): the ranks form a (world / S data, S space) grid
(``parallel.spatial.RankMesh``), rank (g, s) takes data group g's rows of
each batch (``parallel.rank_rows`` over the data groups), draws the
augmentation for the global batch and applies it to whole images, then
keeps its rows [s H / S, (s + 1) H / S) of them. The forward, the loss
and the backward run row-sharded (``parallel.spatial.
build_spatial_loss``): its halos and sums are collectives of the space
and data groups, rank 0 alone seeds the backward of the replicated loss,
and the parameters' gradients are summed over the world
(:func:`spatial_loss_and_grads`), so every rank takes the same update.
``--grad_accum``, ``--ema_decay``, ``--qat``, ``--remat`` and
``--opt_shard`` (Adam's moments sharded over the data groups, replicated
over space) compose with it; validation scores the sharded loss, whose
sums are the same on every rank, and rank 0's sample grid gathers its
images' rows over its space group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from mri_superresolution_torch.config import TrainConfig, to_dict
from mri_superresolution_torch.data import (BatchLoader, PairedSliceDataset,
                                            StreamingBatchLoader,
                                            subject_split, train_val_split)
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.losses.combined import _weighted_mean
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.models import vgg as vgg_mod
from mri_superresolution_torch.models.families import with_weight_widths
from mri_superresolution_torch.ops.augment import augment_pair
from mri_superresolution_torch.parallel import multihost
from mri_superresolution_torch.parallel.mesh import rank_rows, zero1_layout
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.train.plateau import (EarlyStopping,
                                                     ReduceLROnPlateau)
from mri_superresolution_torch.train.zero1 import Zero1Adam
from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.logging import (log_message, set_quiet,
                                                   setup_logging)
from mri_superresolution_torch.utils.spans import span


@contextlib.contextmanager
def repeatable():
    """Training's numerics kept repeatable for the duration: cuDNN takes
    only deterministic algorithms and no autotuned ones
    (``torch.backends.cudnn.deterministic`` on, ``benchmark`` off); the
    flags the caller had are restored after. cuDNN may otherwise pick, for
    a convolution's gradient, an algorithm that sums with atomics in an
    order that changes from run to run, or time its candidates and keep
    another on the next run. On the H100 it picked none such at the zoo's
    training shapes (``tools/repeat_train.py``: the same bits with the
    scope and without), so this is a guard, at no measured cost a step.
    The step and the whole :func:`train` run inside it; serving keeps its
    own algorithm choice."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


def check_spatial(cfg: TrainConfig, world: int) -> int:
    """The data groups of a ``--spatial_shards`` run over ``world`` ranks
    (1 without spatial sharding); ValueError, with the JAX trainer's
    messages, for a family without a row-sharded forward or a shard count
    that does not divide the ranks."""
    if cfg.spatial_shards <= 1:
        return world
    from mri_superresolution_torch.parallel import spatial
    if cfg.model.model_type not in spatial.supported_types():
        raise ValueError(
            f"spatial_shards > 1 supports model types "
            f"{spatial.supported_types()} (parallel/spatial.py "
            f"topologies), not {cfg.model.model_type!r}")
    if world % cfg.spatial_shards != 0:
        raise ValueError(
            f"spatial_shards={cfg.spatial_shards} must divide the {world} "
            f"mesh device(s) (the ranks: --num_devices, or --multihost's "
            f"processes)")
    return world // cfg.spatial_shards


def check_spatial_hw(cfg: TrainConfig, lr_hw) -> None:
    """ValueError, with the JAX trainer's message, for LR images that
    ``cfg.spatial_shards`` row blocks of whole 8-row tiles cannot cover."""
    h, w = lr_hw
    if h % (8 * cfg.spatial_shards) != 0 or w % 8 != 0:
        raise ValueError(
            f"spatial_shards={cfg.spatial_shards} training needs LR "
            f"H % {8 * cfg.spatial_shards} == 0 and W % 8 == 0; got "
            f"{h}x{w}. Re-extract with a conforming --target_size or "
            f"reduce spatial_shards.")


def make_optimizer(params, learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: L2 (wd·θ added to the gradient before the moment
    estimates), the rule of the JAX package's ``optax.chain(
    add_decayed_weights, scale_by_adam)`` (scripts/train.py:186). The
    trainer sets the plateau's lr into the param groups each step."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def adam_state(model: torch.nn.Module, optimizer) -> Dict[str, Any]:
    """Adam's step count and moments keyed like the model's state_dict
    (``{"count", "mu", "nu"}``, optax's ``ScaleByAdamState`` fields);
    zeros before the first step. Of a :class:`Zero1Adam` the moments are
    gathered from every rank: a collective."""
    if isinstance(optimizer, Zero1Adam):
        return optimizer.adam_state()
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p) or {}
        mu[name] = st.get("exp_avg", torch.zeros_like(p)).detach().cpu()
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p)).detach().cpu()
        if "step" in st:
            count = int(st["step"])
    return {"count": count, "mu": mu, "nu": nu}


def load_adam_state(model: torch.nn.Module, optimizer,
                    state: Dict[str, Any]) -> None:
    """Inverse of :func:`adam_state` (a :class:`Zero1Adam` takes its
    rank's slices)."""
    if isinstance(optimizer, Zero1Adam):
        optimizer.load_adam_state(state)
        return
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(state["count"])),
            "exp_avg": state["mu"][name].to(p).reshape(p.shape).clone(),
            "exp_avg_sq": state["nu"][name].to(p).reshape(p.shape).clone()}


def check_qat(cfg: TrainConfig) -> None:
    """Raise ValueError for a ``--qat`` run the trainer cannot do."""
    if not cfg.qat:
        return
    if not quant_forward.supported(cfg.model.model_type):
        raise ValueError(
            f"--qat supports the int8 serving families "
            f"{quant_forward.supported_types()} (models/quant_forward.py), "
            f"not {cfg.model.model_type!r}")
    if not 0.0 < cfg.qat_decay < 1.0:
        raise ValueError(f"qat_decay must be in (0, 1), got {cfg.qat_decay}")


def step_seed(seed: int, epoch: int, batch_idx: int) -> int:
    """The augmentation generator's seed of one step, from (seed, epoch,
    batch): a resumed run draws what an uninterrupted one would."""
    return int(np.random.SeedSequence([seed, epoch, batch_idx])
               .generate_state(1)[0])


@dataclass
class TrainState:
    """The model holds the fp32 master params; ``ema`` their Polyak
    average (a state_dict-keyed dict, None when ema_decay == 0);
    ``qat_amax`` QAT's running per-site per-input-channel max |x|
    (``{site: (Cin,) fp32}`` on the device, None without QAT)."""
    model: torch.nn.Module
    optimizer: Any              # torch.optim.Adam, or a Zero1Adam
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    qat_amax: Optional[Dict[str, torch.Tensor]] = None


def _ssim_metric(loss_fn: CombinedLoss, out, hr, w) -> torch.Tensor:
    """The weighted mean SSIM when the loss has no SSIM term (JAX's
    ``ssim(..., sample_weights=w)``), outside autograd."""
    with torch.no_grad():
        return _weighted_mean(loss_fn.ssim_per_sample(out.detach(), hr), w)


def _forward(model, lo, qat=None):
    """(output, QAT comps) of ``model`` on ``lo``: the module's forward, or
    with ``qat`` = (fakequant forward, running amax) the fakequant forward
    on the model's parameters, whose batch statistic and foreground flag
    come back as ``qat_batch_amax`` and ``qat_any_fg``."""
    with span("train.forward", lo.device):
        if qat is None:
            return model(lo), {}
        fq, amax = qat
        out, batch_amax, any_fg = fq(model.state_dict(keep_vars=True), amax,
                                     lo)
        return out, {"qat_batch_amax": batch_amax, "qat_any_fg": any_fg}


def _loss(model, loss_fn, hr, lo, w, qat=None, ssim_reduce=None):
    out, extra = _forward(model, lo, qat)
    with span("train.loss", hr.device):
        total, comps = loss_fn(out, hr, sample_weights=w,
                               ssim_reduce=ssim_reduce)
        if "ssim_metric" not in comps:   # ssim_weight == 0: metric only
            comps = dict(comps, ssim_metric=_ssim_metric(loss_fn, out, hr, w))
    return total, dict(comps, **extra)


def _detached(comps):
    return {k: ({s: a.detach() for s, a in v.items()} if isinstance(v, dict)
                else v.detach()) for k, v in comps.items()}


class _SsimSums:
    """The ``ssim_reduce`` of one (micro)batch: all-reduces the loss's
    local (weighted SSIM sum, weight sum) and keeps the global weight
    sum; :meth:`den` all-reduces the weight sum alone when the loss had
    no SSIM term to do it."""

    def __init__(self, dp, den_local: torch.Tensor):
        self.dp, self.den_local, self.den_global = dp, den_local, None

    def __call__(self, num: torch.Tensor, den: torch.Tensor):
        num_g, den_g = self.dp.sum_([num, den])
        self.den_global = den_g
        return num_g, den_g

    def den(self) -> torch.Tensor:
        if self.den_global is None:
            self.den_global, = self.dp.sum_([self.den_local])
        return self.den_global

    def share(self) -> Optional[torch.Tensor]:
        """This rank's share of the weights, den_r / den; None at a world
        of one, where it is 1 by definition."""
        if self.dp.world == 1:
            return None
        return self.den_local / self.den().clamp_min(1e-12)

    def reduce(self) -> Optional["_SsimSums"]:
        """The loss's ``ssim_reduce``: this, or None at a world of one,
        where the local clip is the global one."""
        return self if self.dp.world > 1 else None


def loss_and_grads(model: torch.nn.Module, loss_fn: CombinedLoss,
                   hr: torch.Tensor, lo: torch.Tensor, w: torch.Tensor,
                   grad_accum: int = 1, qat=None, dp=None):
    """(loss, comps, grads in ``model.parameters()`` order) of one batch.

    ``grad_accum > 1`` runs that many sequential microbatches, as the JAX
    trainer's ``lax.scan`` (``_make_train_step``): each microbatch's fp32
    gradient is scaled by its weight sum den_i, and the sum is divided by
    the batch's, which is exact because every loss term is a weighted
    mean. The one batch-nonlinear point, the SSIM clip at the batch mean,
    is applied per microbatch; ``comps["ssim_clip_micros"]`` counts the
    microbatches that saturate it. With ``qat`` (see :func:`_forward`)
    every microbatch quantizes with the same running amax, and the batch
    statistic is the max over the microbatches' (background ones give
    zeros, the neutral element), their foreground flags or-ed: the
    full batch's statistic.

    With ``dp`` (a ``multihost.Collectives``) the batch is this rank's
    rows (``parallel.rank_rows``: its part of each microbatch), and the
    result is the JAX mesh step's on the global batch, the same on every
    rank. Each (micro)batch's forward runs first; the loss all-reduces the
    detached weighted SSIM sum and weight sum and clips the global mean
    (``losses.combined.global_clip``), then the backward runs. Without
    accumulation each rank scales its gradients, loss and metric by its
    share of the weights, den_r / den, and one fp32 bucket sums them over
    the ranks (the other components stay the rank's); with accumulation
    the den_j,r-weighted sums of every rank's microbatches are summed and
    divided by the global weight sum. ``ssim_clip_micros`` counts global
    microbatches. QAT's statistic is a max over the ranks, its foreground
    flag an or. Without ``dp`` (``multihost.LOCAL``) every share is 1 and
    every reduction returns its inputs."""
    dp = multihost.LOCAL if dp is None else dp
    params = list(model.parameters())
    a = grad_accum
    g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params] \
        if a > 1 else None
    num_loss = num_ssim = n_sat = torch.zeros((), device=hr.device)
    amax_acc, fg_acc = None, None
    for hr_i, lo_i, w_i in zip(hr.chunk(a), lo.chunk(a), w.chunk(a)):
        den_i = w_i.float().sum()
        sums = _SsimSums(dp, den_i)
        loss_i, comps_i = _loss(model, loss_fn, hr_i, lo_i, w_i, qat,
                                sums.reduce())
        with span("train.backward", loss_i.device):
            g_i = torch.autograd.grad(loss_i, params)
        if qat is not None:
            b = {k: v.detach() for k, v in comps_i["qat_batch_amax"].items()}
            amax_acc = b if amax_acc is None else {
                k: torch.maximum(amax_acc[k], v) for k, v in b.items()}
            f = comps_i["qat_any_fg"]
            fg_acc = f if fg_acc is None else fg_acc | f
        ssim_i = comps_i["ssim_metric"].detach()
        if a == 1:
            share = sums.share()
            loss_i = loss_i.detach()
            if share is not None:
                g_i = [g * share for g in g_i]
                loss_i, ssim_i = loss_i * share, ssim_i * share
            *grads, loss, ssim = dp.sum_(list(g_i) + [loss_i, ssim_i])
            comps = dict(_detached(comps_i), ssim_metric=ssim)
        else:
            # the clip's decision is the global microbatch's (one value
            # on every rank when the loss has an SSIM term)
            n_sat = n_sat + ((sums.den() > 0) & ((ssim_i <= 0.0) |
                                                 (ssim_i >= 1.0))).float()
            g_acc = [acc + den_i * g.float() for acc, g in zip(g_acc, g_i)]
            num_loss = num_loss + den_i * loss_i.detach()
            num_ssim = num_ssim + den_i * ssim_i
    if a > 1:
        *g_acc, num_loss, num_ssim, den = dp.sum_(
            g_acc + [num_loss, num_ssim, w.float().sum()])
        den = den.clamp_min(1e-12)
        grads = [(g / den).to(p.dtype) for g, p in zip(g_acc, params)]
        loss = num_loss / den
        comps = {"ssim_metric": num_ssim / den, "ssim_clip_micros": n_sat}
    if qat is not None:
        keys = list(amax_acc)
        *vals, fg = dp.max_([amax_acc[k] for k in keys] + [fg_acc])
        comps.update(qat_batch_amax=dict(zip(keys, vals)), qat_any_fg=fg)
    return loss, comps, grads


def informative(model: torch.nn.Module, lo: torch.Tensor) -> torch.Tensor:
    """(B,) weights of a batch's pairs by their LR image: 0.0 for an
    all-zero image (an empty slice, which extraction writes as a black
    pair) where ``model`` normalizes with GroupNorm (the unets), 1.0 for
    every other image and family. The unets' convs have no bias, so such
    an image's activations stay 0 through the net and every GroupNorm
    scales its gradient by 1/sqrt(eps) = 316, which overflows within the
    depth: one such pair with a non-zero weight makes the gradient
    non-finite, in the JAX package too. Weight 0 makes its gradient
    exactly 0; elsewhere the pairs weigh as in JAX."""
    ones = torch.ones(lo.shape[0], device=lo.device)
    if not any(isinstance(m, torch.nn.GroupNorm) for m in model.modules()):
        return ones
    return ones * (lo.reshape(lo.shape[0], -1) != 0).any(dim=1)


def update_qat_amax(amax: Dict[str, torch.Tensor], comps, decay: float
                    ) -> Dict[str, torch.Tensor]:
    """QAT's moving-range observer after a step: ``decay * amax + (1 -
    decay) * batch_amax`` if the batch had a foreground sample
    (``comps["qat_any_fg"]``), else ``amax`` unchanged: a background batch
    records zeros, toward which the range must not decay."""
    fg, b = comps["qat_any_fg"], comps["qat_batch_amax"]
    return {k: torch.where(fg, decay * a + (1.0 - decay) * b[k].to(a.dtype),
                           a) for k, a in amax.items()}


def build_train_step(loss_fn: CombinedLoss, augment_cfg=None,
                     grad_accum: int = 1, ema_decay: float = 0.0,
                     qat_fwd=None, qat_decay: float = 0.0, dp=None,
                     rows=None):
    """train_step(state, batch, lr, generator) -> metrics, updating the
    state in place, inside :func:`repeatable`: augmentation (when ``augment_cfg.enabled``, from
    ``generator``), the loss's gradient, the Adam step at ``lr``, and the
    EMA ``ema = ema * d + params * (1 - d)`` after it. ``batch`` holds
    ``hr``, ``lr``, ``weight`` tensors on the model's device; in the
    unets a pair whose LR image is all zero takes weight 0
    (:func:`informative`); metrics are
    device scalars (``loss``, ``ssim``, and ``ssim_clip_micros`` with
    grad_accum).

    With ``qat_fwd`` (``quant_forward.build_fakequant_forward``) the loss
    runs that forward with ``state.qat_amax``, and after the step the
    running amax moves to ``d * amax + (1 - d) * batch_amax`` (d =
    ``qat_decay``) if the batch had a foreground sample, and stays as it
    is otherwise.

    With ``dp`` (a ``multihost.Collectives``) ``batch`` holds the rows
    ``rows`` of the global batch (``parallel.rank_rows``), the
    augmentation is drawn for the global batch and the rows' draws kept,
    and the gradients and metrics are the global batch's
    (:func:`loss_and_grads`); the optimizer may be a :class:`Zero1Adam`."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: float, generator: Optional[torch.Generator] = None):
        with span("train.step"), repeatable():
            return _step(state, batch, lr, generator)

    def _step(state, batch, lr, generator):
        hr, lo = batch["hr"], batch["lr"]
        w = batch["weight"] * informative(state.model, lo)
        if augment_cfg is not None and augment_cfg.enabled:
            hr, lo = augment_pair(
                hr, lo, generator, augment_cfg, rows=rows,
                global_batch=None if rows is None else len(rows) * dp.world)
        qat = None if qat_fwd is None else (qat_fwd, state.qat_amax)
        loss, comps, grads = loss_and_grads(state.model, loss_fn, hr, lo, w,
                                            grad_accum, qat, dp)
        return _update(state, loss, comps, grads, lr, ema_decay,
                       qat_decay if qat is not None else None)

    return train_step


def _update(state: TrainState, loss, comps, grads, lr: float,
            ema_decay: float, qat_decay: Optional[float]) -> dict:
    """The step after its gradients: the Adam step at ``lr``, the EMA
    ``ema = ema * d + params * (1 - d)``, QAT's running amax (with a
    ``qat_decay``); the step's metrics."""
    with span("train.update", loss.device):
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        for p, g in zip(state.model.parameters(), grads):
            p.grad = g
        state.optimizer.step()
        state.step += 1
        if ema_decay > 0.0:
            # Polyak average in fp32, started at the initial params (no
            # bias correction)
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    state.ema[name] = (state.ema[name] * ema_decay
                                       + p.detach() * (1.0 - ema_decay))
        if qat_decay is not None:
            state.qat_amax = update_qat_amax(state.qat_amax, comps,
                                             qat_decay)
    metrics = {"loss": loss, "ssim": comps["ssim_metric"]}
    if "ssim_clip_micros" in comps:
        metrics["ssim_clip_micros"] = comps["ssim_clip_micros"]
    if qat_decay is not None:
        metrics["qat_any_fg"] = comps["qat_any_fg"]
    return metrics


def spatial_loss_and_grads(model: torch.nn.Module, sloss, mesh,
                           hr: torch.Tensor, lo: torch.Tensor,
                           w: torch.Tensor, grad_accum: int = 1,
                           qat_amax=None, coll=None):
    """(loss, comps, grads in ``model.parameters()`` order) of one batch
    through the row-sharded loss ``sloss`` of ``mesh``
    (``parallel.spatial.build_spatial_loss``; with ``qat_amax`` its QAT
    form), the JAX spatial step's ``value_and_grad`` of the one global
    loss.

    On an in-process mesh the batch is the global one and the one
    backward is complete. On a ``RankMesh`` it is this rank's row blocks
    of its data group's rows, ``coll`` the world's collectives: the loss
    and comps are the global batch's on every rank, the sums in its
    backward carry each rank's share to the ranks that need it, so rank 0
    alone seeds the loss (1, the others 0: a seed of 1 on every rank
    would count the loss once a rank), and the ranks' parameter
    gradients are summed over the world, one fp32 bucket, the same bits
    on every rank. ``grad_accum > 1`` runs that many microbatches as
    :func:`loss_and_grads` does: den_i-weighted gradient sums divided by
    the batch's weight sum, ``ssim_clip_micros`` the microbatches whose
    (global) SSIM saturates the clip, QAT's statistic a max over them."""
    params = list(model.parameters())
    sd = model.state_dict(keep_vars=True)
    seed = 1.0 if coll is None or coll.rank == 0 else 0.0
    a = grad_accum
    g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params] \
        if a > 1 else None
    num_loss = num_ssim = n_sat = torch.zeros((), device=hr.device)
    amax_acc, fg_acc = None, None
    for hr_i, lo_i, w_i in zip(hr.chunk(a), lo.chunk(a), w.chunk(a)):
        args = (hr_i, lo_i, w_i) if qat_amax is None else \
            (qat_amax, hr_i, lo_i, w_i)
        loss_i, comps_i, _ = sloss(sd, *args)
        g_i = torch.autograd.grad(loss_i, params,
                                  grad_outputs=torch.full_like(loss_i, seed))
        if qat_amax is not None:
            b = comps_i["qat_batch_amax"]
            amax_acc = b if amax_acc is None else {
                k: torch.maximum(amax_acc[k], v) for k, v in b.items()}
            f = comps_i["qat_any_fg"]
            fg_acc = f if fg_acc is None else fg_acc | f
        if a == 1:
            grads, loss = list(g_i), loss_i.detach()
            comps = _detached(comps_i)
            continue
        den_i = mesh.weight_sum(w_i)
        ssim_i = comps_i["ssim_metric"].detach()
        n_sat = n_sat + ((den_i > 0) & ((ssim_i <= 0.0) |
                                        (ssim_i >= 1.0))).float()
        g_acc = [acc + den_i * g.float() for acc, g in zip(g_acc, g_i)]
        num_loss = num_loss + den_i * loss_i.detach()
        num_ssim = num_ssim + den_i * ssim_i
    if a > 1:
        den = mesh.weight_sum(w).clamp_min(1e-12)
        grads = g_acc
        loss = num_loss / den
        comps = {"ssim_metric": num_ssim / den, "ssim_clip_micros": n_sat}
        if qat_amax is not None:
            comps.update(qat_batch_amax=amax_acc, qat_any_fg=fg_acc)
    if coll is not None:
        grads = coll.sum_(grads)
    if a > 1:
        grads = [(g / den).to(p.dtype) for g, p in zip(grads, params)]
    return loss, comps, grads


def build_spatial_train_step(sloss, mesh, augment_cfg=None,
                             grad_accum: int = 1, ema_decay: float = 0.0,
                             qat: bool = False, qat_decay: float = 0.0,
                             coll=None, rows=None):
    """The row-sharded train step, ``build_train_step``'s contract with
    the loss of ``parallel.spatial.build_spatial_loss`` over ``mesh``
    (``qat``: its QAT form, fed ``state.qat_amax``). ``batch`` holds whole
    images: on a ``RankMesh`` its data group's rows ``rows`` of the
    global batch, the augmentation drawn for the global batch and applied
    to the whole images (a rotation is not shard-local), then this rank's
    row blocks kept (``mesh.rows``); the update is the global batch's
    (:func:`spatial_loss_and_grads`). The optimizer may be a
    :class:`Zero1Adam` over the data group."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: float, generator: Optional[torch.Generator] = None):
        with repeatable():
            return _step(state, batch, lr, generator)

    def _step(state, batch, lr, generator):
        hr, lo = batch["hr"], batch["lr"]
        w = batch["weight"] * informative(state.model, lo)
        if augment_cfg is not None and augment_cfg.enabled:
            hr, lo = augment_pair(
                hr, lo, generator, augment_cfg, rows=rows,
                global_batch=None if rows is None
                else len(rows) * mesh.shape[0])
        loss, comps, grads = spatial_loss_and_grads(
            state.model, sloss, mesh, mesh.rows(hr), mesh.rows(lo), w,
            grad_accum, state.qat_amax if qat else None, coll)
        return _update(state, loss, comps, grads, lr, ema_decay,
                       qat_decay if qat else None)

    return train_step


def build_spatial_eval_step(model: torch.nn.Module, sloss, mesh,
                            qat: bool = False):
    """eval_step(params, batch) -> (metrics, output) through the
    row-sharded loss, under no_grad: ``build_eval_step``'s contract
    (``qat``: ``params`` is the pair (params or None, amax)); the metrics
    are the global batch's on every rank, the output this rank's row
    blocks (``mesh.rows`` of the batch's images)."""

    def eval_step(params, batch: Dict[str, torch.Tensor]):
        with torch.no_grad(), repeatable():
            hr, lo = mesh.rows(batch["hr"]), mesh.rows(batch["lr"])
            args = (hr, lo, batch["weight"])
            if qat:
                params, amax = params
                args = (amax,) + args
            sd = model.state_dict()
            total, comps, out = sloss(sd if params is None
                                      else {**sd, **params}, *args)
            return {"loss": total, "ssim": comps["ssim_metric"]}, out

    return eval_step


def build_eval_step(model: torch.nn.Module, loss_fn: CombinedLoss,
                    qat_fwd=None, dp=None):
    """eval_step(params, batch) -> (metrics, output) under no_grad;
    ``params`` (a state_dict-keyed dict, e.g. the EMA) replaces the
    model's own for the call, None keeps them. With ``qat_fwd``,
    ``params`` is the pair (params or None, amax) and the step scores the
    fakequant forward: the metric of int8 serving. With ``dp`` the batch
    is this rank's rows, the SSIM clip is the global batch's, and the
    metrics are the global batch's, the same on every rank (each rank's
    weighted by its share of the weights, then summed); the output is the
    rank's rows."""

    def eval_step(params, batch: Dict[str, torch.Tensor]):
        with torch.no_grad(), repeatable():
            return _eval(params, batch)

    def _eval(params, batch):
        hr, lo, w = batch["hr"], batch["lr"], batch["weight"]
        if qat_fwd is not None:
            params, amax = params
            sd = model.state_dict()
            out, _, _ = qat_fwd(sd if params is None else {**sd, **params},
                                amax, lo)
        else:
            out = model(lo) if params is None else \
                torch.func.functional_call(model, params, (lo,))
        sums = _SsimSums(multihost.LOCAL if dp is None else dp,
                         w.float().sum())
        total, comps = loss_fn(out, hr, sample_weights=w,
                               ssim_reduce=sums.reduce())
        ssim = comps.get("ssim_metric")
        if ssim is None:
            ssim = _ssim_metric(loss_fn, out, hr, w)
        share = sums.share()
        if share is not None:
            total, ssim = total * share, ssim * share
        total, ssim = sums.dp.sum_([total, ssim])
        return {"loss": total, "ssim": ssim}, out

    return eval_step


def save_example_images(low_res, high_res, output, epoch: int,
                        save_dir: str) -> None:
    """Sample grid PNG per epoch (parity: scripts/train.py:93-131)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    samples = min(4, low_res.shape[0])
    plt.figure(figsize=(15, 5))
    titles = ("Low Resolution", "Generated", "High Resolution")
    for i in range(samples):
        imgs = (low_res[i, :, :, 0], output[i, :, :, 0], high_res[i, :, :, 0])
        for j, img in enumerate(imgs):
            plt.subplot(samples, 3, i * 3 + j + 1)
            plt.imshow(img, cmap="gray")
            if i == 0:
                plt.title(titles[j])
            plt.axis("off")
    plt.tight_layout()
    plt.savefig(os.path.join(save_dir, f"comparison_epoch_{epoch}.png"),
                dpi=150)
    plt.close()


def load_vgg(cfg: TrainConfig, device) -> Optional[vgg_mod.VGG19Features]:
    """The perceptual loss's VGG19 on ``device`` (None without the term):
    ``cfg.vgg_weights`` (an ``.npz`` in the JAX package's format), or
    seeded random weights with a warning, as the JAX trainer falls back."""
    if cfg.loss.perceptual_weight <= 0:
        return None
    if cfg.vgg_weights:
        params = vgg_mod.load_params_npz(cfg.vgg_weights)
        log_message(f"Loaded VGG19 weights from {cfg.vgg_weights}")
    else:
        # a semantics-changing substitution: the reference uses ImageNet
        # VGG19 (utils/losses.py:90); a random CNN is only a structural
        # prior
        log_message(
            "WARNING: perceptual_weight > 0 but no --vgg_weights given. "
            "Falling back to RANDOM VGG features (a structural prior, NOT "
            "the reference's ImageNet-pretrained perceptual loss). Convert "
            "real weights to an .npz of conv{i}/kernel (HWIO) and "
            "conv{i}/bias on a networked machine and pass --vgg_weights, "
            "or set perceptual_weight=0 for exact reference-loss "
            "semantics.", message_type="warning")
        params = vgg_mod.random_params(torch.Generator().manual_seed(0),
                                       cfg.loss.vgg_layer_idx)
    return vgg_mod.VGG19Features.from_params(
        params, cfg.loss.vgg_layer_idx).to(device)


def start_profiler(dev: torch.device):
    """A started ``torch.profiler`` of the CPU and, on the card, CUDA
    activities; None where it cannot start (logged, as the JAX trainer
    logs a backend that cannot trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception as e:  # reported; training goes on untraced
        log_message(f"Profiler unavailable on this backend: {e}")
        return None
    return prof


def stop_profiler(prof, profile_dir: str, epoch: int) -> None:
    """Stop ``prof`` and write its Chrome trace
    (``<profile_dir>/trace_epoch<epoch>.json``)."""
    try:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(profile_dir, f"trace_epoch{epoch}.json"))
        log_message(f"Wrote profiler trace to {profile_dir}")
    except Exception as e:  # reported; the run's results stand
        log_message(f"Profiler stop failed: {e}")


def _meta_step(base: str) -> int:
    """Optimizer step count from a checkpoint's JSON sidecar; -1 when the
    pair is absent or unreadable (never resumed from)."""
    if not (os.path.exists(base + ".ckpt") and os.path.exists(base + ".json")):
        return -1
    try:
        with open(base + ".json") as f:
            return int(json.load(f).get("step", 0))
    except (ValueError, OSError):
        return -1


def _mean(values) -> float:
    return float(torch.stack(values).float().mean()) if values else 0.0


def train(cfg: TrainConfig, progress_cb=None, device=None) -> str:
    """Run training; returns the final checkpoint path. On the card unless
    ``device`` says otherwise (``"cpu"``). Runs inside :func:`repeatable`:
    one seed and one data set give the same checkpoint bits."""
    with repeatable():
        return _train(cfg, progress_cb, device)


def _train(cfg: TrainConfig, progress_cb=None, device=None) -> str:
    check_qat(cfg)
    # data parallel: this process is one rank of a process group
    # (parallel/multihost.py); the path below is the single-device one
    # wherever coll is None
    coll = multihost.Collectives() if multihost.active() else None
    rank, world = multihost.rank(), multihost.world()
    main = rank == 0
    spatial = cfg.spatial_shards > 1
    # the batch splits over the data groups: the ranks, or with spatial
    # sharding the rows of the (n_data, spatial_shards) grid of ranks
    n_data = check_spatial(cfg, world)
    if not main:
        set_quiet(True)
    os.makedirs(cfg.log_dir, exist_ok=True)
    setup_logging(os.path.join(cfg.log_dir, "training.log" if main
                               else f"training.p{rank}.log"))
    dev = resolve_device(device)
    if coll is not None:
        # every rank must derive the same data order and model init; an
        # unseeded --seed default draws a seed in each process, so rank
        # 0's wins
        agreed = multihost.agree(cfg.seed)
        if agreed != cfg.seed:
            log_message(f"Multi-host: replacing this process's seed "
                        f"{cfg.seed} with process 0's {agreed} (seeds must "
                        f"agree; pass an explicit --seed to silence this)",
                        message_type="warning")
            cfg.seed = agreed
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    os.makedirs(os.path.join(cfg.checkpoint_dir, "samples"), exist_ok=True)
    log_message(f"Training on {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})"
                   if dev.type == "cuda" else ""))
    smesh, data_rank = None, rank
    if spatial:
        from mri_superresolution_torch.parallel.spatial import RankMesh
        # every rank is a process, so the space axis spans processes
        log_message(f"Multi-host spatially-sharded training: space-axis "
                    f"halo exchanges and statistic reductions cross process "
                    f"boundaries where the {cfg.spatial_shards}-way space "
                    f"axis spans processes")
        smesh = RankMesh(n_data, cfg.spatial_shards, dev)
        data_rank = smesh.g
        log_message(f"Spatially-sharded training: ({n_data} data x "
                    f"{cfg.spatial_shards} space) mesh — row-sharded "
                    f"forward/loss/backward (halo exchanges, summed "
                    f"statistics)")
    if coll is not None:
        log_message(f"Using mesh with {world} device(s): "
                    f"{multihost.rank_devices()}")
        log_message(f"Multi-host training: {world} processes x 1 local "
                    f"device(s) ({multihost.backend()}); process 0 writes "
                    f"checkpoints/logs/protocol (parallel/multihost.py)")

    # --- data ---
    dataset = PairedSliceDataset(cfg.full_res_dir, cfg.low_res_dir)
    if len(dataset) == 0:
        raise RuntimeError("No valid HR/LR pairs found")
    if cfg.split_by_subject:
        train_idx, val_idx = subject_split(dataset.subjects,
                                           cfg.validation_split, cfg.seed)
        log_message(f"Subject-level split: {len(train_idx)} train / "
                    f"{len(val_idx)} val slices")
    else:
        train_idx, val_idx = train_val_split(len(dataset),
                                             cfg.validation_split, cfg.seed)
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    # the batch must split into grad_accum equal microbatches, and each of
    # them across the data groups
    quantum = n_data * cfg.grad_accum
    batch_size = int(-(-cfg.batch_size // quantum) * quantum)
    if batch_size != cfg.batch_size and coll is None:
        log_message(f"Rounding batch_size {cfg.batch_size} → {batch_size} "
                    f"to divide into {cfg.grad_accum} gradient-accumulation "
                    f"microbatches")
    elif batch_size != cfg.batch_size:
        log_message(f"Rounding batch_size {cfg.batch_size} → {batch_size} "
                    f"to divide the {n_data}-way data axis"
                    + (f" x {cfg.grad_accum} gradient-accumulation "
                       f"microbatches" if cfg.grad_accum > 1 else ""))
    # this rank's rows of each global batch (all of them without a group)
    rows = val_rows = None
    if coll is not None:
        rows = rank_rows(batch_size, n_data, data_rank, cfg.grad_accum)
        val_rows = rank_rows(batch_size, n_data, data_rank)
    if cfg.grad_accum > 1:
        log_message(f"Gradient accumulation: {cfg.grad_accum} sequential "
                    f"microbatches of {batch_size // cfg.grad_accum} per "
                    f"optimizer step (exact full-batch update)")
    decoded_mb = dataset.estimated_decoded_mb()
    if cfg.streaming == "on" or (cfg.streaming == "auto"
                                 and decoded_mb > cfg.streaming_threshold_mb):
        log_message(f"Streaming data loading: dataset decodes to "
                    f"{decoded_mb:.0f} MiB; holding "
                    f"{cfg.streaming_prefetch} prefetched batch(es) in RAM")
        train_loader = StreamingBatchLoader(
            dataset, train_idx, batch_size, shuffle=True, seed=cfg.seed,
            prefetch=cfg.streaming_prefetch, rows=rows)
        val_loader = StreamingBatchLoader(
            dataset, val_idx, batch_size, shuffle=False, seed=cfg.seed,
            prefetch=cfg.streaming_prefetch, rows=val_rows)
    else:
        lr_arr, hr_arr = dataset.load_all()
        train_loader = BatchLoader(lr_arr, hr_arr, train_idx, batch_size,
                                   shuffle=True, seed=cfg.seed, rows=rows)
        val_loader = BatchLoader(lr_arr, hr_arr, val_idx, batch_size,
                                 shuffle=False, seed=cfg.seed, rows=val_rows)

    sample_hw = dataset.item_hw()[0]
    if spatial:
        check_spatial_hw(cfg, sample_hw)

    # resume from whichever of final / step is further along; ties prefer
    # final, whose meta holds the last validated scheduler state
    names = ckpt.checkpoint_paths(cfg.checkpoint_dir, cfg.model.model_type)
    resume_base = None
    if cfg.resume:
        cands = sorted((_meta_step(names[k]), k == "final", k)
                       for k in ("final", "step"))
        if cands[-1][0] >= 0:
            resume_base = names[cands[-1][2]]
    if resume_base is not None:
        params_r, opt_r, meta, extras = ckpt.load_checkpoint(
            resume_base + ".ckpt", return_extras=True,
            model_type=cfg.model.model_type)
        # the widths the weights fix (edsr's depth, swinir's Swin widths,
        # which no sidecar keeps) win over the flags
        cfg = dataclasses.replace(
            cfg, model=with_weight_widths(cfg.model, params_r)[0])

    # --- model / loss / optimizer ---
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    # remat: the same parameters, so checkpoints do not depend on it
    model = build_model(cfg.model, dtype=dtype,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        remat=cfg.remat).to(dev)
    if not 0.0 <= cfg.ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {cfg.ema_decay}")
    ema_on = cfg.ema_decay > 0.0
    if ema_on:
        log_message(
            f"EMA of weights enabled (decay {cfg.ema_decay}, horizon "
            f"~{1.0 / (1.0 - cfg.ema_decay):.0f} steps): validation, "
            f"best-model selection, and checkpointed serving params use the "
            f"averaged weights; live weights stored under 'raw_params' for "
            f"--resume")
    qat_on = cfg.qat
    qat_fwd = None
    if qat_on:
        qat_fwd = quant_forward.build_fakequant_forward(
            cfg.model.model_type, dtype)
        log_message(
            f"QAT enabled (amax EMA decay {cfg.qat_decay}): training "
            f"simulates the int8 serving quantizers (per-input-channel "
            f"activation scales, per-output-channel weights) with "
            f"straight-through gradients; validation/best-model selection "
            f"score the quantized forward; checkpoints export a frozen "
            f"calibration sidecar (<checkpoint>.calib.json) — serve with "
            f"--quant int8 (the sidecar is found beside the checkpoint)")
        if cfg.remat and spatial:
            log_message(
                "QAT + spatial: model-side remat segments are disabled (the "
                "fake-quant statistics would be recorded again by a "
                "recompute — same restriction as dense QAT); the "
                "loss-graph checkpoint still applies.")
        elif cfg.remat:
            log_message("QAT + remat: the fake-quant forward is functional, "
                        "so the model-side remat segments do not apply; the "
                        "loss-graph checkpoint still does")
    if cfg.opt_shard and coll is not None and n_data > 1:
        # ZeRO-1: Adam's moments sharded over the data groups (with
        # spatial sharding, replicated over space); params (and the EMA,
        # which serving reads whole) stay replicated
        optimizer = Zero1Adam(model.named_parameters(), cfg.learning_rate,
                              cfg.weight_decay,
                              coll if smesh is None else
                              multihost.Collectives(dev, smesh.data_pg))
        n_sharded, n_leaves = optimizer.counts()
    else:
        optimizer = make_optimizer(model.parameters(), cfg.learning_rate,
                                   cfg.weight_decay)
        # one rank: every moment "sharded" over the 1-way axis, as JAX
        # counts; the optimizer is the replicated one
        n_sharded = 2 * sum(zero1_layout(tuple(p.shape), 1) is not None
                            for p in model.parameters())
        n_leaves = 2 * len(list(model.parameters())) + 1
    if cfg.opt_shard:
        log_message(f"ZeRO-1 optimizer-state sharding: {n_sharded}/"
                    f"{n_leaves} moment tensors stored sharded over the "
                    f"{n_data}-way data axis (~1/{n_data} per-device "
                    f"optimizer memory)")
    state = TrainState(model, optimizer, 0, None)
    scheduler = ReduceLROnPlateau(cfg.learning_rate, factor=0.5,
                                  patience=cfg.patience // 2)
    early = EarlyStopping(cfg.patience)
    start_epoch, start_cursor = 0, 0
    if resume_base is not None:
        # EMA checkpoints store the averaged weights as "params" and the
        # live ones as "raw_params"; the optimizer resumes from the live
        live = extras.get("raw_params", params_r)
        model.load_state_dict(live)
        if opt_r is not None:
            load_adam_state(model, optimizer, opt_r)
        if ema_on:
            state.ema = {k: v.to(dev).clone() for k, v in params_r.items()}
            if "raw_params" not in extras:
                log_message("Resuming with EMA enabled from a checkpoint "
                            "without EMA state: initializing the average "
                            "from the restored weights")
        if qat_on and "qat_amax" in extras:
            want = quant_forward.amax_template(model.state_dict(),
                                               cfg.model.model_type)
            got = {k: tuple(v.shape) for k, v in extras["qat_amax"].items()}
            if got != want:
                raise ValueError(f"{resume_base}.ckpt: its QAT ranges "
                                 f"{got} do not fit the model's sites "
                                 f"{want}")
            state.qat_amax = {k: v.to(dev)
                              for k, v in extras["qat_amax"].items()}
        elif qat_on:
            log_message("Resuming with QAT enabled from a checkpoint "
                        "without QAT state: the running activation ranges "
                        "will be re-initialized from one batch through the "
                        "RESTORED weights")
        state.step = int(meta.get("step", 0))
        prev_qat = bool((meta.get("config") or {}).get("qat", False))
        if qat_on != prev_qat:
            # validation now scores another forward: the plateau and
            # early-stopping histories (and the best value a best
            # checkpoint must beat) belong to the old one
            log_message(
                f"Resumed checkpoint was trained with qat={prev_qat}; this "
                f"run uses qat={qat_on}. Validation now scores a different "
                f"forward, so the LR-plateau and early-stopping histories "
                f"are reset (weights and optimizer state still resume).")
        else:
            scheduler.load_state_dict(meta["scheduler"])
            early.load_state_dict(meta["early_stopping"])
        start_cursor = int(meta.get("batch_cursor", 0))
        if start_cursor >= len(train_loader) > 0:
            log_message(f"Step-checkpoint batch cursor {start_cursor} >= "
                        f"{len(train_loader)} batches/epoch; resuming at "
                        f"the next epoch")
            start_cursor = 0
            meta["epoch"] = int(meta.get("epoch", 0))
        if start_cursor > 0:
            # re-enter the same epoch and skip its trained batches: the
            # loader order and the augmentation seeds are (seed, epoch,
            # batch)-determined, so the continuation is bit-identical
            start_epoch = int(meta.get("epoch", 0))
            log_message(f"Resumed from {resume_base}.ckpt mid-epoch "
                        f"{start_epoch} at batch {start_cursor} "
                        f"(step {state.step})")
        else:
            start_epoch = int(meta.get("epoch", -1)) + 1
            log_message(f"Resumed from {resume_base}.ckpt at epoch "
                        f"{start_epoch}")
    if ema_on and state.ema is None:
        state.ema = {k: p.detach().clone()
                     for k, p in model.named_parameters()}

    def calib(params, x):
        amax = quant_forward.calib_amax({**model.state_dict(), **params}, x,
                                        cfg.model.model_type, dtype)
        if coll is not None:
            # each rank saw its rows of the batch: the global max
            amax = dict(zip(amax, coll.max_(list(amax.values()))))
        return amax

    qat_serving_calib = None
    if qat_on and (state.qat_amax is None or ema_on):
        # one retained calibration batch, the first of epoch 0
        calib_x = torch.from_numpy(np.asarray(
            next(iter(train_loader.epoch(0)))["lr"])).to(dev)
        if state.qat_amax is None:
            # after the resume on purpose: a --qat --resume fine-tune
            # measures the restored weights' ranges, not the random init's
            log_message("QAT: initializing the running activation ranges "
                        "from one batch through the current weights")
            state.qat_amax = calib({}, calib_x)
        if ema_on:
            # the checkpoint serves the EMA weights: its sidecar and the
            # validation are measured on them, each epoch
            def qat_serving_calib(ema):
                return calib(ema, calib_x)

    if spatial:
        from mri_superresolution_torch.parallel.spatial import (
            build_spatial_loss)
        sloss = build_spatial_loss(
            smesh, sample_hw, cfg.loss, cfg.model.model_type, dtype,
            vgg=load_vgg(cfg, dev), remat=cfg.remat,
            qat_sites=sorted(quant_forward.amax_template(
                model.state_dict(), cfg.model.model_type))
            if qat_on else None)
        train_step = build_spatial_train_step(
            sloss, smesh, cfg.augment, cfg.grad_accum, cfg.ema_decay,
            qat_on, cfg.qat_decay, coll, rows)
        eval_step = build_spatial_eval_step(model, sloss, smesh, qat_on)
    else:
        loss_fn = CombinedLoss(cfg.loss, load_vgg(cfg, dev),
                               remat=cfg.remat)
        train_step = build_train_step(loss_fn, cfg.augment, cfg.grad_accum,
                                      cfg.ema_decay, qat_fwd, cfg.qat_decay,
                                      coll, rows)
        eval_step = build_eval_step(model, loss_fn, qat_fwd, coll)

    writer = None
    if cfg.use_tensorboard and main:
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(cfg.log_dir)
        except ImportError:
            log_message("TensorBoard not available; skipping")

    log_message({
        "model_type": cfg.model.model_type, "batch_size": batch_size,
        "epochs": cfg.epochs, "learning_rate": cfg.learning_rate,
        "weight_decay": cfg.weight_decay,
        "ssim_weight": cfg.loss.ssim_weight,
        "perceptual_weight": cfg.loss.perceptual_weight,
        "initial_alpha": cfg.model.initial_alpha,
        "augmentation": cfg.augment.enabled,
        "validation_split": cfg.validation_split,
        "patience": cfg.patience, "num_devices": world, "device": str(dev),
        "bf16": cfg.bf16, "seed": cfg.seed, "ema_decay": cfg.ema_decay,
        "qat": cfg.qat,
    }, "params")
    if len(val_idx) == 0:
        log_message(
            "WARNING: validation_split leaves 0 validation slices — the LR "
            "scheduler, early stopping, and best-model checkpointing are all "
            "validation-driven and will be DISABLED this run (only the final "
            "checkpoint is written). The reference degrades the same way; "
            "set --validation_split > 0 to restore them.",
            message_type="warning")

    def save_state(base: str, meta: Dict[str, Any]) -> None:
        """Checkpoint the current state: serving params (the EMA when on),
        the live weights under ``raw_params``, Adam's state, and under QAT
        the running ranges (``qat_amax``) and the frozen int8 scales
        beside the checkpoint (``<base>.calib.json``): measured on the EMA
        weights when they are served, else the running ranges. Without
        QAT a sidecar left by an earlier QAT run is removed: it describes
        weights this save overwrites. Data parallel, it is a collective
        (ZeRO-1's moments are gathered from every rank) and rank 0
        alone writes."""
        opt_state = adam_state(model, optimizer)
        if not main:
            return
        live = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        serve = ({k: v.cpu() for k, v in state.ema.items()} if ema_on
                 else live)
        extras = {}
        if ema_on:
            extras["raw_params"] = live
        if qat_on:
            extras["qat_amax"] = {k: v.cpu()
                                  for k, v in state.qat_amax.items()}
        ckpt.save_checkpoint(base, serve, opt_state, meta=meta,
                             model_type=cfg.model.model_type,
                             extras=extras or None)
        sidecar = ckpt.calib_sidecar_path(base)
        if qat_on:
            amax = serving_amax if serving_amax is not None \
                else state.qat_amax
            quant_forward.save_scales(
                sidecar, quant_forward.scales_from_amax(
                    {k: v.cpu().numpy() for k, v in amax.items()}),
                cfg.model.model_type)
        elif os.path.exists(sidecar):
            os.remove(sidecar)
            log_message(f"Removed stale QAT calibration sidecar {sidecar} "
                        f"(its checkpoint was overwritten by a non-QAT run)")

    def put(batch):
        return {k: torch.from_numpy(v).to(dev, non_blocking=True)
                for k, v in batch.items()}

    vis_frequency = max(1, cfg.epochs // 20)
    n_train_batches = len(train_loader)
    hyper_meta = {"config": to_dict(cfg)}
    final_val_loss, final_val_ssim = float("inf"), 0.0
    # QAT with EMA: the ranges of the served (averaged) weights, measured
    # before each validation; a run whose epoch loop does not run measures
    # them here, so that its re-save exports them
    serving_amax = (qat_serving_calib(state.ema)
                    if qat_serving_calib is not None
                    and start_epoch >= cfg.epochs else None)
    grids = True
    profiler = None
    if cfg.profile_dir:
        os.makedirs(cfg.profile_dir, exist_ok=True)
    epoch = start_epoch - 1
    for epoch in range(start_epoch, cfg.epochs):
        if cfg.profile_dir and main and \
                epoch == min(start_epoch + 1, cfg.epochs - 1):
            profiler = start_profiler(dev)
        epoch_start = time.time()
        # metrics stay on the device until the epoch's end; only the
        # sparse batch_update lines synchronize
        loss_accs, ssim_accs, clip_accs = [], [], []
        skip_to = start_cursor if epoch == start_epoch else 0
        for batch_idx, batch in enumerate(train_loader.epoch(epoch)):
            if batch_idx < skip_to:
                continue       # trained before the mid-epoch checkpoint
            gen = None
            if cfg.augment.enabled:
                gen = torch.Generator(device=dev).manual_seed(
                    step_seed(cfg.seed, epoch, batch_idx))
            metrics = train_step(state, put(batch), scheduler.lr, gen)
            loss_accs.append(metrics["loss"])
            ssim_accs.append(metrics["ssim"])
            if "ssim_clip_micros" in metrics:
                clip_accs.append(metrics["ssim_clip_micros"])
            if batch_idx % max(10, n_train_batches // 10) == 0:
                loss_v = float(metrics["loss"])
                log_message({"epoch": epoch, "batch": batch_idx,
                             "total_batches": n_train_batches,
                             "loss": loss_v}, "batch_update")
                if progress_cb and main:
                    progress_cb(epoch, batch_idx, loss_v)
            if (cfg.save_every_steps > 0
                    and state.step % cfg.save_every_steps == 0):
                save_state(names["step"],
                           meta={**hyper_meta, "epoch": epoch,
                                 "batch_cursor": batch_idx + 1,
                                 "step": state.step,
                                 "val_loss": final_val_loss,
                                 "val_ssim": final_val_ssim,
                                 "scheduler": scheduler.state_dict(),
                                 "early_stopping": early.state_dict()})
        train_loss, train_ssim = _mean(loss_accs), _mean(ssim_accs)
        if clip_accs and cfg.loss.ssim_weight > 0:
            n_sat = int(float(torch.stack(clip_accs).sum()))
            if n_sat:
                log_message(
                    f"WARNING: {n_sat} gradient-accumulation microbatch(es) "
                    f"saturated the SSIM clip this epoch — for those steps "
                    f"the accumulated gradient follows the per-microbatch "
                    f"clip, not the exact full-batch one.",
                    message_type="warning")

        # --- validation (every epoch, scripts/train.py:279-280), on the
        # EMA weights when they are on: they are what the checkpoint serves
        val_losses, val_ssims = [], []
        vis_batch, vis_out = None, None
        eval_params = state.ema
        if qat_on:
            # scored on the fakequant forward, with the scales the
            # checkpoint would export
            if qat_serving_calib is not None:
                serving_amax = qat_serving_calib(state.ema)
            eval_params = (state.ema, serving_amax if serving_amax
                           is not None else state.qat_amax)
        for batch in val_loader.epoch():
            metrics, out = eval_step(eval_params, put(batch))
            val_losses.append(metrics["loss"])
            val_ssims.append(metrics["ssim"])
            vis_batch, vis_out = batch, out
        n_val = len(val_losses)
        val_loss, val_ssim = _mean(val_losses), _mean(val_ssims)
        if n_val:
            prev_lr = scheduler.lr
            new_lr = scheduler.step(val_loss)
            if new_lr != prev_lr:
                log_message(f"Learning rate adjusted from {prev_lr:.2e} "
                            f"to {new_lr:.2e}")
            if early.update(val_loss):
                save_state(names["best"],
                           meta={**hyper_meta, "epoch": epoch,
                                 "step": state.step, "val_loss": val_loss,
                                 "val_ssim": val_ssim,
                                 "scheduler": scheduler.state_dict(),
                                 "early_stopping": early.state_dict()})
                log_message(f"Saved best model with validation loss: "
                            f"{val_loss:.6f}")
            final_val_loss, final_val_ssim = val_loss, val_ssim

        if profiler is not None:
            stop_profiler(profiler, cfg.profile_dir, epoch)
            profiler = None

        elapsed = time.time() - epoch_start
        # a mid-epoch-resumed epoch only ran its remaining batches
        n_seen = max(0, len(train_idx) - skip_to * batch_size)
        log_message({
            "epoch": epoch, "total_epochs": cfg.epochs,
            "train_loss": train_loss,
            "val_loss": val_loss if n_val else "N/A",
            "train_ssim": train_ssim,
            "val_ssim": val_ssim if n_val else "N/A",
            "elapsed": elapsed, "lr": scheduler.lr,
            "slices_per_sec": n_seen / max(elapsed, 1e-9),
            "slices_per_sec_per_chip": n_seen / max(elapsed, 1e-9) / world,
            "steps_per_sec": n_train_batches / max(elapsed, 1e-9),
        }, "epoch_summary")
        if writer:
            writer.add_scalar("Loss/train", train_loss, epoch)
            writer.add_scalar("SSIM/train", train_ssim, epoch)
            if n_val:
                writer.add_scalar("Loss/val", val_loss, epoch)
                writer.add_scalar("SSIM/val", val_ssim, epoch)

        if spatial and vis_out is not None and epoch % vis_frequency == 0:
            # rank 0's images, gathered from its space group's row blocks
            # (a collective: every rank takes part, whatever it draws)
            vis_out = smesh.group.gather_rows(vis_out)
        # data parallel: rank 0's rows of the batch (its first B / n_data)
        if grids and main and epoch % vis_frequency == 0 and \
                vis_batch is not None:
            try:
                save_example_images(vis_batch["lr"], vis_batch["hr"],
                                    vis_out.float().cpu().numpy(), epoch,
                                    os.path.join(cfg.checkpoint_dir,
                                                 "samples"))
            except ImportError:
                grids = False
                log_message("matplotlib is not installed; sample grids are "
                            "skipped", message_type="warning")

        if n_val and early.should_stop:
            log_message(f"Early stopping triggered after {epoch + 1} epochs")
            break

    # --- final checkpoint (scripts/train.py:467-477) ---
    save_state(names["final"],
               meta={**hyper_meta, "epoch": epoch, "step": state.step,
                     "val_loss": final_val_loss, "val_ssim": final_val_ssim,
                     "scheduler": scheduler.state_dict(),
                     "early_stopping": early.state_dict()})
    # a completed run supersedes its mid-epoch step checkpoint, which a
    # later --resume in this directory would otherwise prefer
    for suffix in (".ckpt", ".json"):
        if main and os.path.exists(names["step"] + suffix):
            os.remove(names["step"] + suffix)
    log_message(f"Training completed. Final model saved to "
                f"{names['final']}.ckpt")
    if writer:
        writer.close()
    return names["final"] + ".ckpt"
