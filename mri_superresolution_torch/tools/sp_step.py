"""One row-sharded (spatial) training step, from a spec, on every rank of
a job, or over an in-process mesh.

:func:`run_rank` is the rank target that ``parallel.multihost.launch``
starts (``"mri_superresolution_torch.tools.sp_step:run_rank"``, its
arguments the spec's path and an output directory). The spec
(``torch.save``) holds a list of cases (and optionally ``allow_tf32``,
set in each rank before any), each ``tools/dp_step``'s case (a model
config and state_dict, a global batch, the loss config, the step's
options) with its ``mesh``, ``(n_data, n_space)``, whose product is the
world, and optionally ``remat`` and ``vgg`` (a VGG19 param tree for the
perceptual term). Every rank makes the case's ``parallel.spatial.
RankMesh``, takes its data group's rows (``parallel.rank_rows``), runs
the trainer's spatial step (``build_spatial_train_step``) and writes
``OUT_DIR/<case>.rank<r>.pt``: the updated params, their gradients (the
world's sum the update took), Adam's state in the replicated layout,
the EMA, QAT's running ranges, the metrics, the step's kernel launches
and, with ``time_steps``, the milliseconds of a step. A spec's
``train_argv`` then runs the train CLI's rank (``cli.train.run_rank``)
with those flags in the same ranks, which saves a second job's start.

:func:`run_mesh` runs the same step over an in-process ``SpatialMesh``
of ``(n_data, n_space)`` blocks on one device: the reference of the
ranks.
"""

from __future__ import annotations

import os

import torch

from mri_superresolution_torch.config import AugmentConfig, LossConfig
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.models import vgg as vgg_mod
from mri_superresolution_torch.parallel import multihost, spatial
from mri_superresolution_torch.parallel.mesh import rank_rows
from mri_superresolution_torch.tools.dp_step import run_step
from mri_superresolution_torch.train import trainer


def run_case(case: dict, dev, mesh, coll=None, data_coll=None) -> dict:
    """``case``'s step over ``mesh`` (a ``RankMesh`` with the world's
    ``coll`` and its data group's ``data_coll``, or a ``SpatialMesh``),
    through ``tools/dp_step.run_step``."""
    rows = None
    if isinstance(mesh, spatial.RankMesh):
        rows = rank_rows(len(case["batch"]["weight"]), mesh.shape[0], mesh.g,
                         case.get("grad_accum", 1))

    def build(mcfg, dtype):
        lcfg = LossConfig(**case.get("loss", {}))
        vgg = None
        if case.get("vgg") is not None:
            vgg = vgg_mod.VGG19Features.from_params(
                case["vgg"], lcfg.vgg_layer_idx).to(dev)
        qat = bool(case.get("qat"))
        sloss = spatial.build_spatial_loss(
            mesh, tuple(case["batch"]["lr"].shape[1:3]), lcfg,
            mcfg.model_type, dtype, vgg=vgg, remat=bool(case.get("remat")),
            qat_sites=sorted(quant_forward.amax_template(
                case["state_dict"], mcfg.model_type)) if qat else None)
        return trainer.build_spatial_train_step(
            sloss, mesh, AugmentConfig(enabled=bool(case.get("augment"))),
            case.get("grad_accum", 1), case.get("ema_decay", 0.0), qat,
            case.get("qat_decay", 0.98), coll, rows)

    return run_step(case, dev, build, rows, data_coll)


def run_mesh(case: dict, dev) -> dict:
    """``case``'s step over an in-process mesh of its shape, every block
    on ``dev``."""
    n_data, n_space = case["mesh"]
    mesh = spatial.make_spatial_mesh(n_data, n_space,
                                     [torch.device(dev)] * (n_data * n_space))
    return run_case(case, torch.device(dev), mesh)


def run_rank(argv, dev) -> None:
    """The rank target: ``argv`` = [spec, out_dir]."""
    spec_path, out_dir = argv
    spec = torch.load(spec_path, weights_only=False)
    if "allow_tf32" in spec:            # cuDNN's and cuBLAS's TF32 for fp32
        torch.backends.cudnn.allow_tf32 = spec["allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = spec["allow_tf32"]
    coll = multihost.Collectives(dev)
    for case in spec["cases"]:
        mesh = spatial.RankMesh(*case["mesh"], dev)
        data_coll = (multihost.Collectives(dev, mesh.data_pg)
                     if mesh.shape[0] > 1 else None)
        res = run_case(case, dev, mesh, coll, data_coll)
        res["backend"] = multihost.backend()
        torch.save(res, os.path.join(out_dir,
                                     f"{case['name']}.rank{coll.rank}.pt"))
    if spec.get("train_argv"):
        from mri_superresolution_torch.cli.train import run_rank as train
        train(spec["train_argv"], dev)


def rank_results(cases, out_dir, world: int) -> dict:
    """``{case: [rank 0's result, ...]}`` from ``out_dir``."""
    return {c["name"]: [torch.load(os.path.join(
        out_dir, f"{c['name']}.rank{r}.pt"), weights_only=False)
        for r in range(world)] for c in cases}


def same_bits(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in b)


def max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in b)
