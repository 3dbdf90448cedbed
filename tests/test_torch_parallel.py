"""The port's data parallelism against the JAX package's mesh, on the CPU.

Ranks are processes of a gloo group (``parallel/multihost.launch``, each
rank ``python -m mri_superresolution_torch.parallel.multihost``, so it
imports only the port); the JAX side runs on ``conftest.py``'s host
devices. Unet base filters 16, fp32, a batch of 8 LR 16² -> HR 32²
phantoms (PR 7's fixture recipe), augmentation off unless a case says
so. Bars: PR 7's parity bar against JAX, 5e-5 relative L2 a tensor (QAT:
PR 12's bars, since one QAT step of the two packages already differs by
more than that on one device); 1e-5 relative L2 a tensor for the port's
2 ranks against its 1 rank; bit equality where the arithmetic is the same
(ZeRO-1 against the replicated update, the ranks' copies, a world of one
against no process group).

The steps start from JAX's init with its all-zero tensors (GroupNorm
and conv biases, ``alpha``) replaced by seeded draws: from zero, a
tensor's relative L2 after Adam's first step is that of its update alone,
lr · g / (|g| + eps) an element, which moves by a large share wherever
|g| is near eps, on one device as on two (1e-4 at a GroupNorm bias of
the port's one-device step against JAX's on these batches).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mri_superresolution_tpu.config import LossConfig as JaxLossConfig
from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.parallel import make_mesh, zero1_shardings
from mri_superresolution_tpu.parallel.mesh import (
    pad_batch_to_devices as jax_pad)
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_tpu.train import trainer as jtrain
from mri_superresolution_torch import native
from mri_superresolution_torch.cli import train as cli
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.losses.combined import global_clip
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.parallel import (
    multihost, pad_batch_to_devices, rank_rows, zero1_layout)
from mri_superresolution_torch.tools import dp_step
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.subproc import child_env
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

torch.set_num_threads(2)

LR_, WD = 1e-4, 1e-5
B = 8


def _env():
    env = child_env()
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return env


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _max_rel(sd_a, sd_b) -> tuple:
    """Largest relative L2 over the tensors of two state_dicts."""
    return max((_rel(sd_a[k], sd_b[k]), k) for k in sd_b)


def _max_rel_jax(sd, tree) -> tuple:
    la, lb = _leaves(jax_params_from_state_dict(sd)), _leaves(tree)
    assert sorted(la) == sorted(lb)
    return max((_rel(la[k], lb[k]), k) for k in lb)


def _equal(sd_a, sd_b):
    assert sorted(sd_a) == sorted(sd_b)
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k


# ------------------------------------------------------------ layout rules

@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero1_layout_matches_jax_shardings(n):
    """zero1_layout's axis is the one zero1_shardings shards, on every leaf
    of the unet's tree (JAX's shapes), scalars and indivisible leaves
    replicated alike."""
    params = jax.eval_shape(lambda: init_params(
        JaxUNet(base_filters=16), jax.random.key(0), (16, 16)))
    sh = zero1_shardings(params, make_mesh(n))
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_s = jax.tree_util.tree_leaves(
        sh, is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(flat_p) == len(flat_s)
    n_sharded = 0
    for (path, leaf), s in zip(flat_p, flat_s):
        spec = tuple(s.spec) + (None,) * (leaf.ndim - len(s.spec))
        want = spec.index("data") if "data" in spec else None
        assert zero1_layout(leaf.shape, n) == want, (path, leaf.shape)
        n_sharded += want is not None
    assert 0 < n_sharded < len(flat_p)
    for b in (1, 5, 8, 13):
        assert pad_batch_to_devices(b, n) == jax_pad(b, n)


@pytest.mark.parametrize("world,ga", [(2, 1), (2, 2), (4, 2), (8, 1)])
def test_rank_rows_are_parts_of_jax_microbatches(world, ga):
    """Microbatch j of JAX's reshape (trainer.py's ``t.reshape(a, B // a,
    ...)``) is the ranks' j-th chunks of rank_rows, in rank order."""
    b = 16
    micro = np.asarray(jnp.arange(b).reshape(ga, b // ga))
    chunks = [np.split(rank_rows(b, world, r, ga), ga) for r in range(world)]
    for j in range(ga):
        np.testing.assert_array_equal(
            np.concatenate([chunks[r][j] for r in range(world)]), micro[j])
    with pytest.raises(ValueError):
        rank_rows(10, 4, 0, 1)


def test_loaders_give_a_rank_its_rows(pngs):
    """Both loaders with ``rows`` yield those rows of each global batch,
    weights included (the padded last batch's zeros too); the streaming
    loader decodes only them."""
    from mri_superresolution_torch.data import (BatchLoader,
                                                PairedSliceDataset,
                                                StreamingBatchLoader)
    ds = PairedSliceDataset(str(pngs / "hr"), str(pngs / "lr"))
    idx = np.arange(13)
    rows = rank_rows(8, 2, 1, 2)
    lr, hr = ds.load_all()
    full = list(BatchLoader(lr, hr, idx, 8, seed=2).epoch(1))
    mine = list(BatchLoader(lr, hr, idx, 8, seed=2, rows=rows).epoch(1))
    stream = StreamingBatchLoader(ds, idx, 8, seed=2, rows=rows)
    streamed = list(stream.epoch(1))
    assert len(full) == len(mine) == len(streamed) == 2
    for f, m, t in zip(full, mine, streamed):
        for k in ("lr", "hr", "weight"):
            np.testing.assert_array_equal(m[k], f[k][rows])
            np.testing.assert_array_equal(t[k], f[k][rows])
    # rows 2, 3, 6, 7 of a last batch of 5 pairs and 3 padding rows
    assert rows.tolist() == [2, 3, 6, 7]
    assert streamed[1]["weight"].tolist() == [1.0, 1.0, 0.0, 0.0]
    assert stream.decode_batch_calls == 2
    assert all(len(t["lr"]) == len(rows) for t in streamed)


# ---------------------------------------------------- the step, 2 ranks

def _jax_model_params():
    """JAX's init, its all-zero tensors replaced by N(0, 0.05) draws."""
    model = JaxUNet(base_filters=16)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(model, jax.random.key(0), (16, 16)))
    rng = np.random.default_rng(4)

    def draw(a):
        if np.any(a):
            return a
        return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    return model, jax.tree_util.tree_map(draw, params)


def _base_batch():
    return {"lr": phantom_batch(np.random.default_rng(0), B, 16)[..., None],
            "hr": phantom_batch(np.random.default_rng(0), B, 32)[..., None],
            "weight": np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)}


def _port_out(params, lr):
    m = build_model(ModelConfig(base_filters=16))
    m.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        return m(torch.from_numpy(lr)).numpy()


def _saturating_batch(params):
    """Noise inputs; rank 0's targets anti-correlated with the initial
    output (its own mean SSIM < 0), rank 1's an affine copy of it (SSIM
    near 1, L1 away from its kink): the global mean lies in (0, 1)."""
    rng = np.random.default_rng(9)
    lr = rng.random((B, 16, 16, 1), dtype=np.float32)
    out = _port_out(params, lr)
    hr = 0.9 * out + 0.05
    hr[:B // 2] = 1.0 - out[:B // 2]
    return {"lr": lr, "hr": np.clip(hr, 0, 1).astype(np.float32),
            "weight": np.ones(B, np.float32)}


def _ssim_means(batch, params):
    from mri_superresolution_torch.kernels import ssim_per_sample
    out = torch.from_numpy(_port_out(params, batch["lr"]))
    s = ssim_per_sample(out, torch.from_numpy(batch["hr"])).numpy()
    return float(s[:B // 2].mean()), float(s.mean())


def _case(name, params, batch, **kw):
    case = {"name": name, "model": {"base_filters": 16},
            "state_dict": state_dict_from_jax(params), "batch": batch,
            "lr": LR_, "weight_decay": WD, "dtype": "float32"}
    case.update(kw)
    return case


@pytest.fixture(scope="module")
def cases():
    model, params = _jax_model_params()
    batch = _base_batch()
    sat = _saturating_batch(params)
    sd = state_dict_from_jax(params)
    # half the batch's calibration, so that the EMA moves the ranges
    amax = {k: 0.5 * v.numpy() for k, v in qf.calib_amax(
        sd, torch.from_numpy(batch["lr"]), "unet", torch.float32).items()}
    return {"model": model, "params": params, "batch": batch, "sat": sat,
            "amax": amax, "list": [
                _case("plain", params, batch),
                _case("ga2", params, batch, grad_accum=2),
                _case("qat", params, batch, qat=True, qat_amax=amax,
                      qat_decay=0.9),
                _case("sat", params, sat),
                _case("aug_ema", params, batch, augment=True, aug_seed=17,
                      ema_decay=0.9),
                _case("zero1", params, batch, opt_shard=True),
                _case("zero1_ga2", params, batch, opt_shard=True,
                      grad_accum=2)]}


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every case on 2 gloo ranks, in one launch: {case: [rank0, rank1]}."""
    d = tmp_path_factory.mktemp("dp")
    torch.save({"cases": cases["list"]}, d / "spec.pt")
    rc = multihost.launch(
        "mri_superresolution_torch.tools.dp_step:run_rank",
        [str(d / "spec.pt"), str(d)], ["cpu", "cpu"],
        f"127.0.0.1:{multihost.free_port()}", 2, env=_env())
    assert rc == 0
    return {c["name"]: [torch.load(d / f"{c['name']}.rank{r}.pt",
                                   weights_only=False) for r in (0, 1)]
            for c in cases["list"]}


_JAX_STEPS = {}


def _jax_step(model, ga, qat):
    key = (ga, qat)
    if key not in _JAX_STEPS:
        fq = jqf.build_fakequant_forward("unet", jnp.float32) if qat else None
        step = jtrain.build_train_step(
            model, JaxLoss(JaxLossConfig()), jtrain.make_optimizer(WD), None,
            JaxLossConfig(), grad_accum=ga, qat_fwd=fq, qat_decay=0.9)
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
        rsh, dsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
        _JAX_STEPS[key] = (jax.jit(step, in_shardings=(rsh, dsh, None, None),
                                   out_shardings=(rsh, rsh)), rsh, dsh)
    return _JAX_STEPS[key]


def _jax_mesh_step(cases, batch, ga=1, amax=None):
    model, params = cases["model"], cases["params"]
    fn, rsh, dsh = _jax_step(model, ga, amax is not None)
    opt = jtrain.make_optimizer(WD)
    st = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=opt.init(params),
        qat_amax=None if amax is None else
        {k: jnp.asarray(v) for k, v in amax.items()})
    st = jax.device_put(st, rsh)
    jb = {k: jax.device_put(jnp.asarray(v), dsh) for k, v in batch.items()}
    st, met = fn(st, jb, jnp.float32(LR_), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, st), met


@pytest.mark.parametrize("name", ["plain", "ga2", "sat"])
def test_two_rank_step_matches_the_jax_mesh_step(cases, ranks, name):
    """One step on 2 gloo ranks against ``build_train_step`` on a 2-device
    JAX mesh: loss within rtol 1e-5; params, both Adam moments (and QAT's
    running ranges) within 5e-5 relative L2 a tensor; the ranks' params
    bit-identical. ``sat``: rank 0's own mean SSIM is <= 0 while the
    global mean is in (0, 1), asserted on the data first, so a per-rank
    clip would zero rank 0's SSIM gradient where JAX keeps it."""
    case = {c["name"]: c for c in cases["list"]}[name]
    batch = case["batch"]
    if name == "sat":
        own, glob = _ssim_means(batch, cases["params"])
        assert own <= 0.0 < glob < 1.0, (own, glob)
    jst, jmet = _jax_mesh_step(cases, batch, case.get("grad_accum", 1))
    r0, r1 = ranks[name]
    _equal(r0["params"], r1["params"])
    np.testing.assert_allclose(r0["metrics"]["loss"], float(jmet["loss"]),
                               rtol=1e-5)
    for got, want in ((r0["params"], jst.params),
                      (r0["adam"]["mu"], jst.opt_state[1].mu),
                      (r0["adam"]["nu"], jst.opt_state[1].nu)):
        err, key = _max_rel_jax(got, want)
        assert err <= 5e-5, (key, err)
    assert r0["adam"]["count"] == int(jst.opt_state[1].count) == 1


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_two_rank_qat_step_matches_the_jax_mesh_step(cases, ranks):
    """One QAT step on 2 gloo ranks against the JAX mesh's, at the bars of
    tests/test_torch_qat.py::test_qat_train_step_matches_jax (the
    fake-quant codes of the two packages flip apart, so the 5e-5 bar does
    not hold on one device either): loss within rtol 1e-3; the
    foreground flag equal (the running ranges move); the running ranges,
    started at half the batch's calibration, within rtol 1e-2; every
    tensor's update at a cosine >= 0.5 to JAX's, the whole update's
    within 2e-2 of JAX's own under 1e-6 weight noise. The ranks' copies
    bit-identical, and the ranges within rtol 1e-5 of the port's 1-rank
    step (the max over the ranks is the max over the batch)."""
    case = {c["name"]: c for c in cases["list"]}["qat"]
    amax, batch, params = case["qat_amax"], case["batch"], cases["params"]
    jst, jmet = _jax_mesh_step(cases, batch, 1, amax)
    r = np.random.default_rng(1)
    nudged = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6 * r.standard_normal(a.shape)).astype(
            np.float32), params)
    own, _ = _jax_mesh_step(dict(cases, params=nudged), batch, 1, amax)
    r0, r1 = ranks["qat"]
    _equal(r0["params"], r1["params"])
    _equal(r0["qat_amax"], r1["qat_amax"])
    np.testing.assert_allclose(r0["metrics"]["loss"], float(jmet["loss"]),
                               rtol=1e-3)
    _, _, any_fg = jax.jit(jqf.build_fakequant_forward("unet", jnp.float32))(
        params, {k: jnp.asarray(v) for k, v in amax.items()},
        jnp.asarray(batch["lr"]))
    assert r0["metrics"]["qat_any_fg"] == float(bool(any_fg)) == 1.0
    one = dp_step.run_case(case, torch.device("cpu"))
    for k, a0 in amax.items():
        got = r0["qat_amax"][k].numpy()
        assert np.max(np.abs(got - a0) / a0) >= 5e-2, k
        np.testing.assert_allclose(got, np.asarray(jst.qat_amax[k]),
                                   rtol=1e-2, err_msg=k)
        np.testing.assert_allclose(got, one["qat_amax"][k].numpy(),
                                   rtol=1e-5, err_msg=k)
    w0 = state_dict_from_jax(params)

    def update(after, before):
        return {k: (after[k] - before[k]).numpy() for k in w0}

    got = update(r0["params"], w0)
    want = update(state_dict_from_jax(jst.params), w0)
    mine = update(state_dict_from_jax(own.params),
                  state_dict_from_jax(nudged))
    cos = {k: _cos(got[k], want[k]) for k in w0}
    assert min(cos.values()) >= 0.5, cos
    whole, whole_own = (_cos(np.concatenate([np.ravel(u[k]) for k in w0]),
                             np.concatenate([np.ravel(want[k]) for k in w0]))
                        for u in (got, mine))
    assert whole >= whole_own - 2e-2, (whole, whole_own)


def test_global_clip_differs_from_a_rank_clip():
    """On the saturating batch rank 0's SSIM gradient is the local mean's
    under the global clip, and zero under its own clip."""
    per = torch.tensor([-0.3, -0.1], requires_grad=True)
    w = torch.ones(2)
    mean = (per * w).sum() / w.sum()
    local = mean.clamp(0.0, 1.0)
    (g_local,) = torch.autograd.grad(local, per)
    mean = (per * w).sum() / w.sum()
    glob = global_clip(mean, per, w, lambda n, d: (n + 2.4, d + 2.0))
    (g_glob,) = torch.autograd.grad(glob, per)
    assert float(g_local.abs().sum()) == 0.0
    np.testing.assert_allclose(g_glob.numpy(), [0.5, 0.5])
    np.testing.assert_allclose(float(glob.detach()), 2.0 / 4.0)


def test_two_ranks_match_one_rank_with_augmentation_and_ema(cases, ranks):
    """Augmentation on (drawn for the global batch, each rank keeping its
    rows' draws) and an EMA of 0.9: the 2-rank step within 1e-5 relative
    L2 a tensor of the port's 1-rank step on the global batch, params,
    moments and EMA; the ranks' copies bit-identical."""
    case = {c["name"]: c for c in cases["list"]}["aug_ema"]
    one = dp_step.run_case(case, torch.device("cpu"))
    r0, r1 = ranks["aug_ema"]
    _equal(r0["params"], r1["params"])
    _equal(r0["ema"], r1["ema"])
    for got, want in ((r0["params"], one["params"]),
                      (r0["adam"]["mu"], one["adam"]["mu"]),
                      (r0["adam"]["nu"], one["adam"]["nu"]),
                      (r0["ema"], one["ema"])):
        err, key = _max_rel(got, want)
        assert err <= 1e-5, (key, err)
    np.testing.assert_allclose(r0["metrics"]["loss"], one["metrics"]["loss"],
                               rtol=1e-6)


@pytest.mark.parametrize("name,ref", [("zero1", "plain"),
                                      ("zero1_ga2", "ga2")])
def test_zero1_gives_the_replicated_bits(ranks, name, ref):
    """--opt_shard on 2 ranks: the replicated 2-rank update's params and
    gathered Adam state bit for bit, each rank holding about half the
    moment bytes."""
    for r in (0, 1):
        z, rep = ranks[name][r], ranks[ref][r]
        _equal(z["params"], rep["params"])
        assert z["adam"]["count"] == rep["adam"]["count"]
        _equal(z["adam"]["mu"], rep["adam"]["mu"])
        _equal(z["adam"]["nu"], rep["adam"]["nu"])
        share = z["moment_bytes"] / rep["moment_bytes"]
        assert 0.5 <= share <= 0.52, share


def test_thread_ranks_give_the_process_ranks_bits(cases, ranks):
    """``dp_step.run_threads`` (the ranks as threads adding their fp32
    partial gradients, the card's exact reference) gives the gloo ranks'
    bits; a world of one takes the same bits as no process group."""
    case = {c["name"]: c for c in cases["list"]}["plain"]
    dev = torch.device("cpu")
    threads = dp_step.run_threads(case, 2, dev)
    for r in (0, 1):
        _equal(threads[r]["params"], ranks["plain"][r]["params"])
        _equal(threads[r]["adam"]["mu"], ranks["plain"][r]["adam"]["mu"])
    for name in ("plain", "ga2", "qat"):
        case = {c["name"]: c for c in cases["list"]}[name]
        alone = dp_step.run_case(case, dev)
        (world1,) = dp_step.run_threads(case, 1, dev)
        _equal(world1["params"], alone["params"])
        _equal(world1["adam"]["nu"], alone["adam"]["nu"])
        assert world1["metrics"]["loss"] == alone["metrics"]["loss"]


# ------------------------------------------------------------ the train CLI

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """16 phantom pairs (LR 16², HR 32²) of 4 subjects."""
    d = tmp_path_factory.mktemp("pngs_dp")
    hr = phantom_batch(np.random.default_rng(1), 16, 32)
    lr = phantom_batch(np.random.default_rng(1), 16, 16)
    for sub in ("hr", "lr"):
        (d / sub).mkdir()
    for i in range(16):
        name = f"sub-{i // 4:02d}_T1w_s{i:03d}.png"
        native.imwrite_gray(str(d / "hr" / name),
                            np.round(hr[i] * 255).astype(np.uint8))
        native.imwrite_gray(str(d / "lr" / name),
                            np.round(lr[i] * 255).astype(np.uint8))
    return d


def _argv(pngs, ck, *extra):
    return ["--full_res_dir", str(pngs / "hr"), "--low_res_dir",
            str(pngs / "lr"), "--base_filters", "16", "--batch_size", "4",
            "--epochs", "1", "--no_bf16", "--cpu", "--checkpoint_dir",
            str(ck), "--log_dir", str(ck / "logs"), *extra]


def _cli(args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "mri_superresolution_torch.cli.train", *args],
        env=dict(_env(), **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def cli_runs(pngs, tmp_path_factory):
    """The data-parallel CLI runs, started together: ``--num_devices 2
    --cpu --opt_shard`` (seed 3), a coordinated ``--multihost`` pair, one
    rank each, the second started with seed 4, ``--multihost`` at a world
    of one, and ``--multihost`` with no coordinator under the variables
    ``torchrun`` sets (a world of one); their outputs and directories."""
    d = tmp_path_factory.mktemp("cli_dp")
    port = multihost.free_port()
    mh = ["--multihost", "--coordinator", f"127.0.0.1:{port}",
          "--num_processes", "2"]
    port1, port2 = multihost.free_port(), multihost.free_port()
    procs = {
        "spawn": _cli(_argv(pngs, d / "spawn", "--num_devices", "2",
                            "--opt_shard", "--seed", "3")),
        "mh0": _cli(_argv(pngs, d / "mh", *mh, "--process_id", "0",
                          "--seed", "3")),
        "mh1": _cli(_argv(pngs, d / "mh", *mh, "--process_id", "1",
                          "--seed", "4")),
        "world1": _cli(_argv(pngs, d / "world1", "--multihost",
                             "--coordinator", f"127.0.0.1:{port1}",
                             "--num_processes", "1", "--process_id", "0",
                             "--opt_shard", "--seed", "3")),
        "torchrun": _cli(_argv(pngs, d / "torchrun", "--multihost",
                               "--seed", "3"),
                         env={"MASTER_ADDR": "127.0.0.1",
                              "MASTER_PORT": str(port2), "WORLD_SIZE": "1",
                              "RANK": "0", "LOCAL_RANK": "0"})}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[k] = (p.returncode, stdout, stderr)
    return d, out


def _protocol(stdout):
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


def test_cli_num_devices_runs_two_ranks(pngs, cli_runs, tmp_path):
    """``--num_devices 2 --cpu`` starts 2 gloo ranks: rank 0 alone speaks
    the protocol (``num_devices`` 2) and writes training.log and the
    checkpoints, rank 1 writes training.p1.log; the checkpoint is within
    1e-5 relative L2 a tensor of a 1-rank run's."""
    d, out = cli_runs
    rc, stdout, stderr = out["spawn"]
    assert rc == 0, stderr[-3000:]
    lines = _protocol(stdout)
    params = [ln for ln in lines if ln["type"] == "params"]
    assert len(params) == 1 and params[0]["num_devices"] == 2
    assert len([ln for ln in lines if ln["type"] == "epoch_summary"]) == 1
    logs = sorted(os.listdir(d / "spawn" / "logs"))
    assert logs == ["training.log", "training.p1.log"]
    assert "ZeRO-1 optimizer-state sharding" in \
        (d / "spawn" / "logs" / "training.log").read_text()
    one = cli.main(_argv(pngs, tmp_path / "one", "--seed", "3"))
    sd1, _, _ = ckpt.load_checkpoint(one)
    sd2, _, _ = ckpt.load_checkpoint(str(d / "spawn" /
                                         "final_model_unet.ckpt"))
    err, key = _max_rel(sd2, sd1)
    assert err <= 1e-5, (key, err)


def test_cli_multihost_pair_takes_rank_zeros_seed(cli_runs):
    """Two coordinated ``--multihost`` processes, one rank each: the same
    checkpoint bytes as ``--num_devices 2`` (whose ``--opt_shard`` gives
    the replicated bits); the process started with seed 4 takes rank 0's
    3, with the warning, in its training.p1.log."""
    d, out = cli_runs
    for k in ("mh0", "mh1"):
        assert out[k][0] == 0, out[k][2][-3000:]
    assert _protocol(out["mh1"][1]) == []
    assert _bytes(d / "mh" / "final_model_unet.ckpt") == \
        _bytes(d / "spawn" / "final_model_unet.ckpt")
    log1 = (d / "mh" / "logs" / "training.p1.log").read_text()
    assert "replacing this process's seed 4 with process 0's 3" in log1
    assert "Multi-host training: 2 processes" in \
        (d / "mh" / "logs" / "training.log").read_text()


def test_cli_opt_shard_checkpoint_resumes_and_loads_in_jax(pngs, cli_runs,
                                                           tmp_path):
    """The 2-rank ``--opt_shard`` checkpoint resumes in a 1-rank run (one
    more epoch) and loads in the JAX package's ``load_checkpoint`` with
    its full moments; ``--multihost`` at a world of one with
    ``--opt_shard``, and under ``torchrun``'s variables, write a plain
    run's bytes."""
    d, out = cli_runs
    for k in ("world1", "torchrun"):
        assert out[k][0] == 0, out[k][2][-3000:]
    src = d / "spawn"
    path = str(src / "final_model_unet.ckpt")
    jp, _, _ = jax_ckpt.load_checkpoint(path)
    _, opt, _ = jax_ckpt.load_checkpoint(
        path, jtrain.make_optimizer(WD).init(jp))
    _, popt, _ = ckpt.load_checkpoint(path)
    assert int(opt[1].count) == popt["count"] > 0
    got = _leaves(opt[1].mu)
    for k, v in _leaves(jax_params_from_state_dict(popt["mu"])).items():
        np.testing.assert_array_equal(got[k], v)
    ck = tmp_path / "resume"
    ck.mkdir()
    for f in os.listdir(src):
        if f.endswith((".ckpt", ".json")):
            (ck / f).write_bytes(_bytes(src / f))
    final = cli.main(_argv(pngs, ck, "--seed", "3", "--resume",
                           "--epochs", "2"))
    _, opt2, meta2 = ckpt.load_checkpoint(final)
    assert opt2["count"] == 2 * popt["count"] and meta2["epoch"] == 1
    plain = cli.main(_argv(pngs, tmp_path / "plain", "--seed", "3"))
    for k in ("world1", "torchrun"):
        assert _bytes(d / k / "final_model_unet.ckpt") == _bytes(plain), k


def test_cli_rank_failure_ends_the_launch(tmp_path):
    """Ranks that fail (here: no pairs to train on) make the launcher exit
    with their code once it has stopped them all."""
    argv = ["--full_res_dir", str(tmp_path / "none"), "--low_res_dir",
            str(tmp_path / "none"), "--cpu", "--checkpoint_dir",
            str(tmp_path / "ck"), "--log_dir", str(tmp_path / "ck" / "logs")]
    rc = multihost.launch("mri_superresolution_torch.cli.train:run_rank",
                          argv, ["cpu", "cpu"],
                          f"127.0.0.1:{multihost.free_port()}", 2,
                          env=_env())
    assert rc != 0


@pytest.mark.parametrize("how", ["torchrun", "coordinator"])
def test_cli_multihost_without_cpu_needs_a_card(pngs, tmp_path, monkeypatch,
                                                how):
    """``--multihost`` without ``--cpu`` runs its rank on a card: with none
    visible it raises, naming ``--cpu``, before it joins a group, under
    ``torchrun``'s variables and with a coordinator alike."""
    assert not torch.cuda.is_available()
    argv = [a for a in _argv(pngs, tmp_path / "ck") if a != "--cpu"]
    port = str(multihost.free_port())
    if how == "torchrun":
        for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                     "WORLD_SIZE": "1", "RANK": "0",
                     "LOCAL_RANK": "0"}.items():
            monkeypatch.setenv(k, v)
        argv += ["--multihost"]
    else:
        argv += ["--multihost", "--coordinator", f"127.0.0.1:{port}",
                 "--num_processes", "1", "--process_id", "0"]
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main(argv)
    assert not multihost.active()
