"""Single-device trainer of the model zoo: bf16 compute on fp32 master
weights.

An own copy of the JAX package's ``train/trainer.py`` for one device.
Reference behaviour reproduced (scripts/train.py:142-484): Adam (lr 1e-4,
weight decay 1e-5 as L2 added to the gradient before the moments),
ReduceLROnPlateau (factor .5, patience patience//2), a seeded train/val
split, the per-batch SSIM metric, the JSON-line protocol (``params``,
``batch_update``, ``epoch_summary``), best/final checkpoints, early
stopping, optional TensorBoard and periodic sample grids.

Every family of the JAX package trains (``unet``, ``unet_tpu``, ``edsr``,
``simple``), with the full ``CombinedLoss``: L1, SSIM and the VGG19
perceptual term (``--vgg_weights``, an ``.npz`` in the JAX package's
format; without it seeded random VGG weights, with a warning, as the JAX
trainer does). On the card every GroupNorm+LeakyReLU runs kernel B1
forward and backward, the unet's two narrow 3x3 convs kernel B3, and the
loss's SSIM kernel B2 (``kernels/``: each wrapper is an
``autograd.Function`` where autograd needs it). Augmentation runs on the
device from a ``torch.Generator`` seeded from (seed, epoch, batch), as the
JAX trainer folds its key, so a resumed run replays the same draws.
Checkpoints are the JAX package's format (``train/checkpoint.py``), the
optimizer state included, so runs resume across packages.

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
traces: ``min(start_epoch + 1, epochs - 1)``, its validation included.
The JAX trainer's mesh, multi-host, spatial sharding and ZeRO-1 are not
ported: :func:`check_supported` names the ROADMAP item that ports each.
"""

from __future__ import annotations

import contextlib
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
from mri_superresolution_torch.ops.augment import augment_pair
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.train.plateau import (EarlyStopping,
                                                     ReduceLROnPlateau)
from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.logging import log_message, setup_logging


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


def check_supported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for a training mode of the JAX trainer
    that the port does not run yet, naming the ROADMAP item that ports it."""
    later = [
        (cfg.spatial_shards > 1, "--spatial_shards > 1", "A14"),
        (cfg.opt_shard, "--opt_shard (ZeRO-1)", "A14"),
        (cfg.num_data_devices > 1, "--num_devices > 1", "A14"),
    ]
    for on, what, item in later:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch trainer yet (ROADMAP "
                f"{item}); the JAX package's scripts/train.py runs it")


def make_optimizer(params, learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: L2 (wd·θ added to the gradient before the moment
    estimates), the rule of the JAX package's ``optax.chain(
    add_decayed_weights, scale_by_adam)`` (scripts/train.py:186). The
    trainer sets the plateau's lr into the param groups each step."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def adam_state(model: torch.nn.Module,
               optimizer: torch.optim.Adam) -> Dict[str, Any]:
    """Adam's step count and moments keyed like the model's state_dict
    (``{"count", "mu", "nu"}``, optax's ``ScaleByAdamState`` fields);
    zeros before the first step."""
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p) or {}
        mu[name] = st.get("exp_avg", torch.zeros_like(p)).detach().cpu()
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p)).detach().cpu()
        if "step" in st:
            count = int(st["step"])
    return {"count": count, "mu": mu, "nu": nu}


def load_adam_state(model: torch.nn.Module, optimizer: torch.optim.Adam,
                    state: Dict[str, Any]) -> None:
    """Inverse of :func:`adam_state`."""
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
    optimizer: torch.optim.Adam
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
    if qat is None:
        return model(lo), {}
    fq, amax = qat
    out, batch_amax, any_fg = fq(model.state_dict(keep_vars=True), amax, lo)
    return out, {"qat_batch_amax": batch_amax, "qat_any_fg": any_fg}


def _loss(model, loss_fn, hr, lo, w, qat=None):
    out, extra = _forward(model, lo, qat)
    total, comps = loss_fn(out, hr, sample_weights=w)
    if "ssim_metric" not in comps:   # ssim_weight == 0: metric only
        comps = dict(comps, ssim_metric=_ssim_metric(loss_fn, out, hr, w))
    return total, dict(comps, **extra)


def _detached(comps):
    return {k: ({s: a.detach() for s, a in v.items()} if isinstance(v, dict)
                else v.detach()) for k, v in comps.items()}


def loss_and_grads(model: torch.nn.Module, loss_fn: CombinedLoss,
                   hr: torch.Tensor, lo: torch.Tensor, w: torch.Tensor,
                   grad_accum: int = 1, qat=None):
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
    full batch's statistic."""
    params = list(model.parameters())
    if grad_accum == 1:
        total, comps = _loss(model, loss_fn, hr, lo, w, qat)
        grads = torch.autograd.grad(total, params)
        return total.detach(), _detached(comps), grads
    a = grad_accum
    g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    num_loss = num_ssim = n_sat = torch.zeros((), device=hr.device)
    amax_acc, fg_acc = None, None
    for hr_i, lo_i, w_i in zip(hr.chunk(a), lo.chunk(a), w.chunk(a)):
        loss_i, comps_i = _loss(model, loss_fn, hr_i, lo_i, w_i, qat)
        g_i = torch.autograd.grad(loss_i, params)
        if qat is not None:
            b = {k: v.detach() for k, v in comps_i["qat_batch_amax"].items()}
            amax_acc = b if amax_acc is None else {
                k: torch.maximum(amax_acc[k], v) for k, v in b.items()}
            f = comps_i["qat_any_fg"]
            fg_acc = f if fg_acc is None else fg_acc | f
        den_i = w_i.float().sum()
        ssim_i = comps_i["ssim_metric"].detach()
        n_sat = n_sat + ((den_i > 0) & ((ssim_i <= 0.0) | (ssim_i >= 1.0))
                         ).float()
        g_acc = [acc + den_i * g.float() for acc, g in zip(g_acc, g_i)]
        num_loss = num_loss + den_i * loss_i.detach()
        num_ssim = num_ssim + den_i * ssim_i
    den = w.float().sum().clamp_min(1e-12)
    grads = [(g / den).to(p.dtype) for g, p in zip(g_acc, params)]
    comps = {"ssim_metric": num_ssim / den, "ssim_clip_micros": n_sat}
    if qat is not None:
        comps.update(qat_batch_amax=amax_acc, qat_any_fg=fg_acc)
    return num_loss / den, comps, grads


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
                     qat_fwd=None, qat_decay: float = 0.0):
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
    is otherwise."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: float, generator: Optional[torch.Generator] = None):
        with repeatable():
            return _step(state, batch, lr, generator)

    def _step(state, batch, lr, generator):
        hr, lo = batch["hr"], batch["lr"]
        w = batch["weight"] * informative(state.model, lo)
        if augment_cfg is not None and augment_cfg.enabled:
            hr, lo = augment_pair(hr, lo, generator, augment_cfg)
        qat = None if qat_fwd is None else (qat_fwd, state.qat_amax)
        loss, comps, grads = loss_and_grads(state.model, loss_fn, hr, lo, w,
                                            grad_accum, qat)
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
        if qat is not None:
            state.qat_amax = update_qat_amax(state.qat_amax, comps,
                                             qat_decay)
        metrics = {"loss": loss, "ssim": comps["ssim_metric"]}
        if "ssim_clip_micros" in comps:
            metrics["ssim_clip_micros"] = comps["ssim_clip_micros"]
        return metrics

    return train_step


def build_eval_step(model: torch.nn.Module, loss_fn: CombinedLoss,
                    qat_fwd=None):
    """eval_step(params, batch) -> (metrics, output) under no_grad;
    ``params`` (a state_dict-keyed dict, e.g. the EMA) replaces the
    model's own for the call, None keeps them. With ``qat_fwd``,
    ``params`` is the pair (params or None, amax) and the step scores the
    fakequant forward: the metric of int8 serving."""

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
        total, comps = loss_fn(out, hr, sample_weights=w)
        ssim = comps.get("ssim_metric")
        if ssim is None:
            ssim = _ssim_metric(loss_fn, out, hr, w)
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
    check_supported(cfg)
    check_qat(cfg)
    os.makedirs(cfg.log_dir, exist_ok=True)
    setup_logging(os.path.join(cfg.log_dir, "training.log"))
    dev = resolve_device(device)
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    os.makedirs(os.path.join(cfg.checkpoint_dir, "samples"), exist_ok=True)
    log_message(f"Training on {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})"
                   if dev.type == "cuda" else ""))

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
    # the batch must split into grad_accum equal microbatches
    batch_size = int(-(-cfg.batch_size // cfg.grad_accum) * cfg.grad_accum)
    if batch_size != cfg.batch_size:
        log_message(f"Rounding batch_size {cfg.batch_size} → {batch_size} "
                    f"to divide into {cfg.grad_accum} gradient-accumulation "
                    f"microbatches")
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
            prefetch=cfg.streaming_prefetch)
        val_loader = StreamingBatchLoader(
            dataset, val_idx, batch_size, shuffle=False, seed=cfg.seed,
            prefetch=cfg.streaming_prefetch)
    else:
        lr_arr, hr_arr = dataset.load_all()
        train_loader = BatchLoader(lr_arr, hr_arr, train_idx, batch_size,
                                   shuffle=True, seed=cfg.seed)
        val_loader = BatchLoader(lr_arr, hr_arr, val_idx, batch_size,
                                 shuffle=False, seed=cfg.seed)

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
        if cfg.remat:
            log_message("QAT + remat: the fake-quant forward is functional, "
                        "so the model-side remat segments do not apply; the "
                        "loss-graph checkpoint still does")
    optimizer = make_optimizer(model.parameters(), cfg.learning_rate,
                               cfg.weight_decay)
    state = TrainState(model, optimizer, 0, None)
    scheduler = ReduceLROnPlateau(cfg.learning_rate, factor=0.5,
                                  patience=cfg.patience // 2)
    early = EarlyStopping(cfg.patience)
    start_epoch, start_cursor = 0, 0
    names = ckpt.checkpoint_paths(cfg.checkpoint_dir, cfg.model.model_type)

    # resume from whichever of final / step is further along; ties prefer
    # final, whose meta holds the last validated scheduler state
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
        return quant_forward.calib_amax({**model.state_dict(), **params}, x,
                                        cfg.model.model_type, dtype)

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

    loss_fn = CombinedLoss(cfg.loss, load_vgg(cfg, dev), remat=cfg.remat)
    train_step = build_train_step(loss_fn, cfg.augment, cfg.grad_accum,
                                  cfg.ema_decay, qat_fwd, cfg.qat_decay)
    eval_step = build_eval_step(model, loss_fn, qat_fwd)

    writer = None
    if cfg.use_tensorboard:
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
        "patience": cfg.patience, "num_devices": 1, "device": str(dev),
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
        weights this save overwrites."""
        live = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        serve = ({k: v.cpu() for k, v in state.ema.items()} if ema_on
                 else live)
        extras = {}
        if ema_on:
            extras["raw_params"] = live
        if qat_on:
            extras["qat_amax"] = {k: v.cpu()
                                  for k, v in state.qat_amax.items()}
        ckpt.save_checkpoint(base, serve, adam_state(model, optimizer),
                             meta=meta, model_type=cfg.model.model_type,
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
        if cfg.profile_dir and epoch == min(start_epoch + 1, cfg.epochs - 1):
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
                if progress_cb:
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
            "slices_per_sec_per_chip": n_seen / max(elapsed, 1e-9),
            "steps_per_sec": n_train_batches / max(elapsed, 1e-9),
        }, "epoch_summary")
        if writer:
            writer.add_scalar("Loss/train", train_loss, epoch)
            writer.add_scalar("SSIM/train", train_ssim, epoch)
            if n_val:
                writer.add_scalar("Loss/val", val_loss, epoch)
                writer.add_scalar("SSIM/val", val_ssim, epoch)

        if grids and epoch % vis_frequency == 0 and vis_batch is not None:
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
        if os.path.exists(names["step"] + suffix):
            os.remove(names["step"] + suffix)
    log_message(f"Training completed. Final model saved to "
                f"{names['final']}.ckpt")
    if writer:
        writer.close()
    return names["final"] + ".ckpt"
