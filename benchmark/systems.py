"""The systems a cell can put under test: the program, or the control.

``program`` is the port, ``mri_superresolution_torch``, through its own
entry points: ``InferenceEngine`` as ``infer_volume --serve_raw
--out_dtype int16`` builds it, and ``train.trainer.build_train_step``
with the ``TrainConfig`` defaults. This is the one module of the benchmark that
imports the port, and it does so inside the functions that build it.

``control`` is the reference (``reference.py``, ``configs/<name>.py``)
computed in fp8, put in the program's place with the same interface; the
comparison that decides ``correct`` must refuse it.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from benchmark import reference

# TrainConfig's defaults (reference scripts/train.py:486-548)
LEARNING_RATE = 1e-4
WEIGHT_DECAY = 1e-5
SSIM_WEIGHT = 0.3


def _model_config(cfg: dict):
    from mri_superresolution_torch.config import ModelConfig
    extra = {"num_blocks": cfg["num_blocks"]} if "num_blocks" in cfg else {}
    return ModelConfig(model_type=cfg["port_model_type"],
                       in_channels=cfg["in_channels"],
                       out_channels=cfg["out_channels"],
                       base_filters=cfg["base_filters"], **extra)


def serving_engine(cfg: dict, params: Dict[str, torch.Tensor], device):
    """The port's engine as ``--serve_raw --out_dtype int16`` builds it:
    bf16 on fp32 params, stored int16 voxels normalized on the card, the
    NIfTI layout swapped on the card both ways."""
    from mri_superresolution_torch.infer import InferenceEngine
    return InferenceEngine(_model_config(cfg), params, bf16=True,
                           out_dtype=np.int16, device=device,
                           normalize_inputs=True, transpose_io=True)


class ControlEngine:
    """The engine's serving interface over the fp8 reference."""

    normalize_inputs = True

    def __init__(self, forward, params, device):
        self._fwd = lambda x: forward(params, x, "fp8")
        self.device = torch.device(device)

    def upscale_batch(self, batch: np.ndarray) -> np.ndarray:
        with torch.no_grad(), reference.fp32():
            raw = torch.from_numpy(np.ascontiguousarray(batch)).to(
                self.device)
            return reference.serve_raw_int16(self._fwd, raw).cpu().numpy()

    def upscale_batches(self, batches, depth: int = 2):
        for b in batches:
            yield self.upscale_batch(b)

    @contextlib.contextmanager
    def page_locked(self, arr):
        yield arr


def make_engine(system: str, cfg: dict, ref, params, device):
    if system == "program":
        return serving_engine(cfg, params, device)
    if system == "control":
        return ControlEngine(ref.forward, params, device)
    raise ValueError(f"unknown system {system!r}")


class ProgramTrainer:
    """The port's training step (``build_train_step`` over the parity
    loss, Adam at the defaults, bf16 compute on fp32 masters) and the
    state it updates."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], device,
                 dtype=torch.bfloat16):
        from mri_superresolution_torch.config import LossConfig
        from mri_superresolution_torch.losses import CombinedLoss
        from mri_superresolution_torch.models import build_model
        from mri_superresolution_torch.train import trainer
        model = build_model(_model_config(cfg), dtype=dtype)
        model.load_state_dict(params, strict=True)
        model.to(device)
        self.state = trainer.TrainState(model, trainer.make_optimizer(
            model.parameters(), LEARNING_RATE, WEIGHT_DECAY))
        self._step = trainer.build_train_step(
            CombinedLoss(LossConfig(ssim_weight=SSIM_WEIGHT)))

    def __call__(self, batch: Dict[str, torch.Tensor]):
        return self._step(self.state, batch, LEARNING_RATE)["loss"]

    def first_grad(self) -> Dict[str, torch.Tensor]:
        """The first step's gradient as Adam took it: m_1 / (1 - beta1)."""
        opt, model = self.state.optimizer, self.state.model
        b1 = opt.param_groups[0]["betas"][0]
        return {k: opt.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)).detach() / (1.0 - b1)
                for k, p in model.named_parameters()}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone()
                for k, p in self.state.model.named_parameters()}

    def snapshot(self) -> dict:
        """Copies of the params and of Adam's state (queued on the device:
        no synchronise), in the reference's ``Adam`` layout."""
        opt = self.state.optimizer
        named = list(self.state.model.named_parameters())
        st = {k: opt.state.get(p, {}) for k, p in named}

        def moment(name):
            return {k: st[k][name].detach().clone() if name in st[k]
                    else torch.zeros_like(p) for k, p in named}
        step = st[named[0][0]].get("step", 0)
        return {"params": self.params(), "exp_avg": moment("exp_avg"),
                "exp_avg_sq": moment("exp_avg_sq"),
                "step": step.clone() if torch.is_tensor(step) else step}


class ControlTrainer:
    """The reference's step in fp8 with the trainer's interface."""

    def __init__(self, forward, params: Dict[str, torch.Tensor]):
        self._fwd = forward
        self._p = {k: v.detach().clone().requires_grad_(True)
                   for k, v in params.items()}
        self._opt = reference.Adam(self._p, LEARNING_RATE, WEIGHT_DECAY)

    def __call__(self, batch):
        with reference.fp32():
            out = self._fwd(self._p, batch["lr"], "fp8")
            loss = reference.l1_ssim_loss(out, batch["hr"], SSIM_WEIGHT)
            grads = torch.autograd.grad(loss, list(self._p.values()))
        self._opt.step(self._p, dict(zip(self._p, grads)))
        return loss.detach()

    def first_grad(self):
        return self._opt.first_grad

    def params(self):
        return {k: v.detach().clone() for k, v in self._p.items()}

    def snapshot(self) -> dict:
        return dict(self._opt.state(), params=self.params())


def make_trainer(system: str, cfg: dict, ref, params, device):
    if system == "program":
        return ProgramTrainer(cfg, params, device)
    if system == "control":
        return ControlTrainer(ref.forward, params)
    raise ValueError(f"unknown system {system!r}")
