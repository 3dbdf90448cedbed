"""One data-parallel training step, from a spec, on every rank of a job.

:func:`run_rank` is the rank target that ``parallel.multihost.launch``
starts (``"mri_superresolution_torch.tools.dp_step:run_rank"``, its
arguments the spec's path and an output directory). The spec
(``torch.save``) holds a list of cases (and optionally
``allow_tf32``, set in each rank before any), each a model config and
state_dict, a global batch (numpy ``lr``, ``hr``, ``weight``), the loss
config, and the step's options (``grad_accum``, ``ema_decay``, ``qat``,
``opt_shard``, augmentation, lr, compute dtype). Every rank takes its rows
(``parallel.rank_rows``), runs the trainer's step (``build_train_step``
with the rank's ``multihost.Collectives``) and writes
``OUT_DIR/<case>.rank<r>.pt``: the updated params, their gradients (the
ones the update took), Adam's state gathered into the replicated layout,
the EMA, QAT's running ranges, the metrics, the moment bytes the rank
holds, the step's kernel launches and, with ``time_steps``, step and
(over ranks) all-reduce milliseconds.

:func:`run_threads` runs the same ranks as threads of one process over
:class:`ThreadGroup`, whose collectives add and compare the ranks'
tensors in rank order: each rank's rows at the rank's batch, its fp32
partial gradients added, with no process group.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mri_superresolution_torch import kernels
from mri_superresolution_torch.config import (AugmentConfig, LossConfig,
                                              ModelConfig)
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model, quant_forward
from mri_superresolution_torch.parallel import multihost
from mri_superresolution_torch.parallel.mesh import rank_rows
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.train.zero1 import Zero1Adam

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ThreadGroup:
    """The collectives of ``multihost.Collectives`` for ranks that are
    threads of one process: every rank posts its tensors, and each gets
    the ranks' sum (added in rank order), max or list."""

    def __init__(self, world: int):
        self.world = world
        self._barrier = threading.Barrier(world)
        self._posted: List[Optional[list]] = [None] * world

    def view(self, rank: int) -> "_ThreadRank":
        return _ThreadRank(self, rank)

    def _exchange(self, rank: int, tensors: list) -> List[list]:
        self._posted[rank] = [t.detach() for t in tensors]
        self._barrier.wait()
        out = [list(p) for p in self._posted]
        self._barrier.wait()
        return out


class _ThreadRank:
    def __init__(self, group: ThreadGroup, rank: int):
        self.group, self.rank, self.world = group, rank, group.world
        self.timed, self.seconds = False, 0.0

    def _reduce(self, tensors, fn) -> list:
        posted = self.group._exchange(self.rank, [t.float() for t in tensors])
        out = []
        for i, t in enumerate(tensors):
            acc = posted[0][i]
            for r in range(1, self.world):
                acc = fn(acc, posted[r][i])
            out.append(acc.to(t.device, t.dtype))
        return out

    def sum_(self, tensors) -> list:
        return self._reduce(list(tensors), torch.add)

    def max_(self, tensors) -> list:
        return self._reduce(list(tensors), torch.maximum)

    def gather(self, t: torch.Tensor) -> list:
        return [p[0].clone() for p in self.group._exchange(self.rank, [t])]


def _case_batch(case: dict, rows, dev) -> Dict[str, torch.Tensor]:
    b = case["batch"]
    idx = np.arange(len(b["weight"])) if rows is None else rows
    return {k: torch.from_numpy(np.ascontiguousarray(b[k][idx])).to(dev)
            for k in ("lr", "hr", "weight")}


def run_case(case: dict, dev, coll=None) -> dict:
    """``case``'s step on this rank (``coll`` a ``multihost.Collectives``
    or a :class:`ThreadGroup` rank; None: one process on the global
    batch)."""
    rows = None
    if coll is not None:
        rows = rank_rows(len(case["batch"]["weight"]), coll.world, coll.rank,
                         case.get("grad_accum", 1))

    def build(mcfg, dtype):
        qat_fwd = None
        if case.get("qat"):
            qat_fwd = quant_forward.build_fakequant_forward(mcfg.model_type,
                                                            dtype)
        return trainer.build_train_step(
            CombinedLoss(LossConfig(**case.get("loss", {}))),
            AugmentConfig(enabled=bool(case.get("augment"))),
            case.get("grad_accum", 1), case.get("ema_decay", 0.0), qat_fwd,
            case.get("qat_decay", 0.98), coll, rows)

    return run_step(case, dev, build, rows, coll, coll)


def run_step(case: dict, dev, build_step, rows=None, opt_coll=None,
             coll=None) -> dict:
    """One step of ``build_step(model_config, dtype)`` (a trainer's step
    builder) from ``case``'s model, optimizer and state, on ``rows`` of
    its batch (None: all of it), Adam's moments sharded over
    ``opt_coll`` under ``opt_shard``; then, with ``time_steps``, its
    milliseconds (and ``coll``'s all-reduce's): the result a rank
    writes."""
    torch.manual_seed(0)
    dtype = _DTYPES[case.get("dtype", "float32")]
    mcfg = ModelConfig(**case["model"])
    model = build_model(mcfg, dtype=dtype).to(dev)
    model.load_state_dict(case["state_dict"])
    lr, wd = case.get("lr", 1e-4), case.get("weight_decay", 1e-5)
    if case.get("opt_shard") and opt_coll is not None:
        opt = Zero1Adam(model.named_parameters(), lr, wd, opt_coll)
    else:
        opt = trainer.make_optimizer(model.parameters(), lr, wd)
    ema = case.get("ema_decay", 0.0)
    state = trainer.TrainState(model, opt, 0, {
        k: p.detach().clone() for k, p in model.named_parameters()}
        if ema > 0 else None)
    if case.get("qat"):
        state.qat_amax = {k: torch.as_tensor(v).to(dev)
                          for k, v in case["qat_amax"].items()}
    step = build_step(mcfg, dtype)
    batch = _case_batch(case, rows, dev)

    def gen():
        if not case.get("augment"):
            return None
        return torch.Generator(device=dev).manual_seed(case["aug_seed"])

    kernels.reset_launch_counts()
    metrics = step(state, batch, lr, gen())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    out = {"params": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
           "grads": {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()},
           "adam": _cloned(trainer.adam_state(model, opt)),
           "ema": None if state.ema is None else
           {k: v.cpu() for k, v in state.ema.items()},
           "qat_amax": None if state.qat_amax is None else
           {k: v.cpu() for k, v in state.qat_amax.items()},
           "metrics": {k: float(v) for k, v in metrics.items()},
           "moment_bytes": (opt.moment_bytes() if isinstance(opt, Zero1Adam)
                            else sum(s[k].numel() * s[k].element_size()
                                     for s in opt.state.values()
                                     for k in ("exp_avg", "exp_avg_sq"))),
           "launches": launches}
    n = case.get("time_steps", 0)
    if n:
        out.update(_times(step, state, batch, lr, gen, coll, dev, n))
    return out


def _cloned(adam: dict) -> dict:
    """Adam's state, its tensors copied (on the CPU ``adam_state``'s are
    the optimizer's own, which later steps update)."""
    return {"count": adam["count"],
            **{k: {n: t.clone() for n, t in adam[k].items()}
               for k in ("mu", "nu")}}


def _times(step, state, batch, lr, gen, coll, dev, n: int) -> dict:
    """Milliseconds of a step (mean of ``n`` after one warm-up) and, with
    ``coll``, of the all-reduce of one gradient bucket alone, on this
    rank."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step(state, batch, lr, gen())
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch, lr, gen())
    sync()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    if coll is None:
        return {"step_ms": step_ms}
    grads = [p.detach().float() for p in state.model.parameters()]
    coll.sum_(grads)
    coll.timed, coll.seconds = True, 0.0
    for _ in range(n):
        coll.sum_(grads)
    coll.timed = False
    return {"step_ms": step_ms, "allreduce_ms": coll.seconds / n * 1e3,
            "allreduce_bytes": 4 * sum(g.numel() for g in grads)}


def run_rank(argv, dev) -> None:
    """The rank target: ``argv`` = [spec, out_dir]."""
    spec_path, out_dir = argv
    spec = torch.load(spec_path, weights_only=False)
    if "allow_tf32" in spec:            # cuDNN's and cuBLAS's TF32 for fp32
        torch.backends.cudnn.allow_tf32 = spec["allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = spec["allow_tf32"]
    coll = multihost.Collectives(dev)
    for case in spec["cases"]:
        res = run_case(case, dev, coll)
        res["backend"] = multihost.backend()
        torch.save(res, os.path.join(out_dir,
                                     f"{case['name']}.rank{coll.rank}.pt"))


def run_threads(case: dict, world: int, dev) -> List[dict]:
    """``case`` on ``world`` ranks that are threads of this process
    (:class:`ThreadGroup`); the ranks' results in rank order. cuDNN's
    flags are set for all of them at once: the trainer's per-call
    :func:`trainer.repeatable` would restore them under another rank."""
    group = ThreadGroup(world)
    results: List[Optional[dict]] = [None] * world
    errors = []

    def body(r):
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            results[r] = run_case(case, dev, group.view(r))
        except Exception as e:          # re-raised by the caller
            errors.append(e)
            group._barrier.abort()

    with trainer.repeatable():
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results
