"""The port's row-sharded (spatial) training over ranks of a gloo group,
on the CPU.

Ranks are processes (``parallel/multihost.launch``, each running
``tools/sp_step.run_rank``, so it imports only the port): one launch of
2 ranks as a (1, 2) grid, which then runs the train CLI's rank with
``--spatial_shards 2``, and one of 4 ranks as a (2, 2) grid, every case
of a grid in its launch. Each case's step over the ranks
(``parallel.spatial.RankSpaceGroup``) is held against the same step over
the in-process ``SpaceGroup`` (``tools/sp_step.run_mesh``): the loss and
metrics to the bit, the gradients within 1e-6 max abs (the world's sum
of the ranks' gradients and autograd's sum over the in-process blocks
add in other orders); the ranks' params to the bit; the (2, 2) step
against JAX's ``build_spatial_train_step`` at ``tests/test_spatial.py``'s
bars, and ZeRO-1's step (moments sharded over the data groups) with the
replicated step's bits. Unet base filters 16, fp32, LR 32², a batch of
4.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import NamedSharding, PartitionSpec as P

from mri_superresolution_tpu.config import LossConfig as JaxLossConfig
from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.models import build_model as jax_build_model
from mri_superresolution_tpu.parallel import build_spatial_loss as jax_loss
from mri_superresolution_tpu.parallel import make_spatial_mesh as jax_mesh
from mri_superresolution_tpu.parallel import replicated_sharding
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_tpu.train import trainer as jtrain
from mri_superresolution_torch import native
from mri_superresolution_torch.cli import train as cli
from mri_superresolution_torch.config import TrainConfig
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.parallel import multihost
from mri_superresolution_torch.tools import sp_step
from mri_superresolution_torch.train.trainer import check_spatial_hw
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.subproc import child_env
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _env():
    env = child_env()
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return env


@pytest.fixture(scope="module")
def setup():
    model = jax_build_model(JaxModelConfig(base_filters=16),
                            dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 1)))["params"])
    rng = np.random.default_rng(5)
    batch = {"lr": rng.random((4, 32, 32, 1), np.float32),
             "hr": rng.random((4, 64, 64, 1), np.float32),
             "weight": np.array([1, 1, 1, 0], np.float32)}
    sd = state_dict_from_jax(params)
    amax = {k: 0.5 * v.numpy() for k, v in qf.calib_amax(
        sd, torch.from_numpy(batch["lr"]), "unet", torch.float32).items()}
    return params, sd, batch, amax


def _case(name, sd, batch, mesh, **kw):
    case = {"name": name, "model": {"base_filters": 16}, "state_dict": sd,
            "batch": batch, "dtype": "float32", "mesh": mesh,
            "loss": {"ssim_weight": 0.3}, "lr": 1e-4, "weight_decay": 1e-5}
    case.update(kw)
    return case


def _cases(setup, world):
    """The (1, 2) grid: the plain step, and one with augmentation, an EMA
    and remat (collectives recomputed in the backward). The (2, 2) grid,
    whose ranks hold halos, space sums and data sums at once: the plain
    step, ``grad_accum`` 2, QAT, and ZeRO-1 with and without
    ``grad_accum``."""
    _, sd, batch, amax = setup
    mesh = (world // 2, 2)
    cases = [_case("plain", sd, batch, mesh)]
    if world == 2:
        return cases + [_case("aug_remat", sd, batch, mesh, augment=True,
                              aug_seed=3, ema_decay=0.9, remat=True)]
    return cases + [
        _case("ga2", sd, batch, mesh, grad_accum=2),
        _case("qat", sd, batch, mesh, qat=True, qat_amax=amax,
              qat_decay=0.9),
        _case("zero1", sd, batch, mesh, opt_shard=True),
        _case("zero1_ga2", sd, batch, mesh, opt_shard=True, grad_accum=2)]


@contextlib.contextmanager
def _fds_to(out, err):
    """This process's stdout into ``out`` and stderr into ``err`` (apart,
    or the logs split the protocol's lines), and so its children's, for
    the duration."""
    saved = [os.dup(1), os.dup(2)]
    with open(out, "ab") as f, open(err, "ab") as e:
        os.dup2(f.fileno(), 1)
        os.dup2(e.fileno(), 2)
    try:
        yield
    finally:
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        for fd in saved:
            os.close(fd)


def _launch(cases, world, d, train_argv=None):
    torch.save({"cases": cases, "train_argv": train_argv}, d / "spec.pt")
    with _fds_to(d / "ranks.out", d / "ranks.err"):
        rc = multihost.launch(
            "mri_superresolution_torch.tools.sp_step:run_rank",
            [str(d / "spec.pt"), str(d)], ["cpu"] * world,
            f"127.0.0.1:{multihost.free_port()}", world, env=_env())
    assert rc == 0, (d / "ranks.err").read_text()[-3000:]
    return sp_step.rank_results(cases, str(d), world)


@pytest.fixture(scope="module")
def grids(setup, tmp_path_factory):
    """Every case on 2 ranks (1, 2) and on 4 ranks (2, 2), one launch a
    grid: ``{world: (cases, {case: [rank results]})}``. The 2 ranks then
    run the train CLI's rank with ``--num_devices 2 --spatial_shards 2``
    on LR 16² pairs (``cli``: its directory)."""
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"sp{world}")
        train_argv = None
        if world == 2:
            _write_pngs(d / "p16", 16)
            train_argv = _argv(d / "p16", d / "cli", "--num_devices", "2",
                               "--spatial_shards", "2")
            out["cli"] = d
        cases = _cases(setup, world)
        out[world] = (cases, _launch(cases, world, d, train_argv))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_rank_group_matches_the_in_process_group(grids, world):
    """Each case over the ranks against the same step over the in-process
    group of the same grid: loss and metrics the same bits, gradients
    within 1e-6, the ranks' params and QAT ranges the same bits."""
    cases, res = grids[world]
    for case in cases:
        ranks = res[case["name"]]
        ref = sp_step.run_mesh(case, CPU)
        assert ranks[0]["backend"] == "gloo"
        assert ranks[0]["metrics"] == ref["metrics"], case["name"]
        assert sp_step.max_abs(ranks[0]["grads"], ref["grads"]) <= 1e-6, \
            case["name"]
        for r in ranks[1:]:
            assert sp_step.same_bits(r["params"], ranks[0]["params"])
            assert sp_step.same_bits(r["grads"], ranks[0]["grads"])
            if case.get("qat"):
                assert sp_step.same_bits(r["qat_amax"], ranks[0]["qat_amax"])


def test_zero1_gives_the_replicated_bits(grids):
    """``--opt_shard`` on the (2, 2) grid: Adam's moments sharded over the
    2 data groups, replicated over space, give the replicated update's
    params and moments to the bit, with and without ``grad_accum``."""
    _, res = grids[4]
    for name, ref in (("zero1", "plain"), ("zero1_ga2", "ga2")):
        for r in range(4):
            got, want = res[name][r], res[ref][r]
            assert sp_step.same_bits(got["params"], want["params"])
            assert sp_step.same_bits(got["adam"]["mu"], want["adam"]["mu"])
            assert sp_step.same_bits(got["adam"]["nu"], want["adam"]["nu"])


def test_rank_step_matches_jax(setup, grids):
    """The (2, 2) ranks' step against JAX's ``build_spatial_train_step``
    on its (2, 2) mesh: loss within rtol 1e-4, SSIM within rtol 1e-3 atol
    1e-5, params within 2.5e-4 with the 0.99-quantile within 5e-5
    (``tests/test_spatial.py:252-307``)."""
    params, _, batch, _ = setup
    mesh = jax_mesh(2, 2)
    opt = jtrain.make_optimizer(1e-5)
    sl = jax_loss(mesh, (32, 32), JaxLossConfig(ssim_weight=0.3), "unet",
                  jnp.float32)
    rsh = replicated_sharding(mesh)
    x4 = NamedSharding(mesh, P("data", "space"))
    dsh = {"hr": x4, "lr": x4, "weight": NamedSharding(mesh, P("data"))}
    step = jax.jit(jtrain.build_spatial_train_step(sl, opt, None),
                   in_shardings=(rsh, dsh, None, None),
                   out_shardings=(rsh, rsh))
    st = jax.device_put(jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=opt.init(params)), rsh)
    st, met = step(st, batch, jnp.asarray(1e-4, jnp.float32),
                   jax.random.key(0))
    got = grids[4][1]["plain"][0]
    np.testing.assert_allclose(got["metrics"]["loss"], float(met["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["ssim"], float(met["ssim"]),
                               rtol=1e-3, atol=1e-5)
    diff = np.abs(np.asarray(ravel_pytree(
        jax_params_from_state_dict(got["params"]))[0])
        - np.asarray(ravel_pytree(st.params)[0]))
    assert diff.max() <= 2.5e-4 and np.quantile(diff, 0.99) <= 5e-5


# ------------------------------------------------------------ the train CLI

def _write_pngs(d, lr_size):
    hr = phantom_batch(np.random.default_rng(1), 16, 2 * lr_size)
    lr = phantom_batch(np.random.default_rng(1), 16, lr_size)
    for sub in ("hr", "lr"):
        (d / sub).mkdir(parents=True)
    for i in range(16):
        name = f"sub-{i // 4:02d}_T1w_s{i:03d}.png"
        native.imwrite_gray(str(d / "hr" / name),
                            np.round(hr[i] * 255).astype(np.uint8))
        native.imwrite_gray(str(d / "lr" / name),
                            np.round(lr[i] * 255).astype(np.uint8))


def _argv(pngs, ck, *extra):
    return ["--full_res_dir", str(pngs / "hr"), "--low_res_dir",
            str(pngs / "lr"), "--base_filters", "16", "--batch_size", "4",
            "--epochs", "1", "--no_bf16", "--cpu", "--seed", "3",
            "--checkpoint_dir", str(ck), "--log_dir", str(ck / "logs"),
            *extra]


def test_cli_trains_row_sharded_over_two_ranks(grids):
    """The train CLI's rank with ``--num_devices 2 --spatial_shards 2
    --cpu``, in the (1, 2) launch's two ranks as the CLI starts them:
    rank 0 alone speaks the protocol (``num_devices`` 2) and logs the JAX
    trainer's lines (the multi-host spatial line, then the (1 data x 2
    space) mesh); rank 1 writes ``training.p1.log``; the checkpoint loads
    in the JAX package with its optimizer state."""
    d = grids["cli"]
    lines = [json.loads(ln) for ln in
             (d / "ranks.out").read_text().splitlines()
             if ln.startswith("{")]
    params = [ln for ln in lines if ln["type"] == "params"]
    assert len(params) == 1 and params[0]["num_devices"] == 2
    assert len([ln for ln in lines if ln["type"] == "epoch_summary"]) == 1
    log = (d / "cli" / "logs" / "training.log").read_text()
    a = log.index("Multi-host spatially-sharded training")
    b = log.index("Spatially-sharded training: (1 data x 2 space) mesh")
    assert a < b
    assert sorted(os.listdir(d / "cli" / "logs")) == ["training.log",
                                                      "training.p1.log"]
    path = str(d / "cli" / "final_model_unet.ckpt")
    jp, _, meta = jax_ckpt.load_checkpoint(path)
    _, opt, _ = jax_ckpt.load_checkpoint(
        path, jtrain.make_optimizer(1e-5).init(jp))
    assert int(opt[1].count) > 0 and meta["config"]["spatial_shards"] == 2
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree_util.tree_leaves(jp))


def test_cli_rejects_shards_that_do_not_divide(tmp_path):
    """``--spatial_shards 3`` with ``--num_devices 2``: the CLI raises
    before it starts a rank (the script exits 1), naming what 3 must
    divide; LR 24² with 2 shards: the JAX trainer's LR-shape message,
    which every rank raises once it has read the pairs' size."""
    with pytest.raises(ValueError,
                       match="spatial_shards=3 must divide the 2 mesh"):
        cli.main(_argv(tmp_path, tmp_path / "ck", "--num_devices", "2",
                       "--spatial_shards", "3"))
    assert not (tmp_path / "ck").exists()
    with pytest.raises(ValueError, match=(
            r"training needs LR H % 16 == 0 and W % 8 == 0; got 24x24")):
        check_spatial_hw(TrainConfig(spatial_shards=2), (24, 24))
