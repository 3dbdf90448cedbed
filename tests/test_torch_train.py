"""The port's training step, checkpoints and train CLI against the JAX
package, on the CPU, at a small size: unet base filters 16, LR 16² → HR
32², batch 4 (the last row a padding row of weight 0), fp32. Inputs are
MRI-like phantoms (``utils/phantom``), made with numpy and given to both."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_superresolution_tpu.config import LossConfig as JaxLossConfig
from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.models import vgg as jvgg
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_tpu.train import trainer as jtrain
from mri_superresolution_torch import native
from mri_superresolution_torch.cli import train as cli
from mri_superresolution_torch.config import LossConfig, ModelConfig
from mri_superresolution_torch.kernels.groupnorm import group_norm_leaky
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.models import vgg as vgg_mod
from mri_superresolution_torch.models import unet as unet_mod
from mri_superresolution_torch.ops.functional import group_norm_fp32
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

torch.set_num_threads(2)

LR_, WD = 1e-4, 1e-5
ALPHA = 25.0


def _tree(sd):
    return jax_params_from_state_dict(sd)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_rel(tree_a, tree_b) -> tuple:
    la, lb = _leaves(tree_a), _leaves(tree_b)
    assert sorted(la) == sorted(lb)
    return max((_rel(la[k], lb[k]), k) for k in la)


@pytest.fixture(scope="module")
def setup():
    model = JaxUNet(base_filters=16, initial_alpha=ALPHA)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(model, jax.random.key(0), (16, 16)))
    batch = {"lr": phantom_batch(np.random.default_rng(0), 4, 16)[..., None],
             "hr": phantom_batch(np.random.default_rng(0), 4, 32)[..., None],
             "weight": np.array([1, 1, 1, 0], np.float32)}
    return model, params, batch


def _port(params):
    m = build_model(ModelConfig(base_filters=16, initial_alpha=ALPHA))
    m.load_state_dict(state_dict_from_jax(params))
    return m


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_one_step_loss_and_grads_match_jax(setup, monkeypatch):
    """Loss within rtol 1e-5; every gradient within rtol 1e-4 (the bar of
    tests/test_unet.py:66), atol 1e-5 of the tensor's largest entry.

    The comparison holds away from the LeakyReLU's kink: where a z lies
    within fp32 rounding of 0, the two packages may take its derivative
    from either side. The test checks that no z of this batch lies within
    two ulp of 1 (2.4e-7) of it."""
    model, params, batch = setup
    jl = JaxLoss(JaxLossConfig())
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jl(model.apply({"params": p}, batch["lr"]), batch["hr"],
                     batch["weight"]), has_aux=True))(params)

    closest = []

    def spy(x, scale, bias, residual=None, n_groups=8, eps=1e-5):
        z = group_norm_fp32(x.detach(), scale.detach(), bias.detach(),
                            n_groups, eps)
        closest.append(float(z.abs().min()))
        return group_norm_leaky(x, scale, bias, residual=residual,
                                n_groups=n_groups, eps=eps)

    monkeypatch.setattr(unet_mod, "group_norm_leaky", spy)
    m = _port(params)
    tb = _tb(batch)
    loss, comps, grads = trainer.loss_and_grads(
        m, CombinedLoss(LossConfig()), tb["hr"], tb["lr"], tb["weight"])
    assert len(closest) == 20 and min(closest) > 2.4e-7, closest
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _leaves(_tree(dict(zip([n for n, _ in m.named_parameters()],
                                 grads))))
    want = _leaves(jg)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_one_step_with_perceptual_loss_matches_jax(setup):
    """The unet's step with ``perceptual_weight`` 0.1 (VGG19 to relu5_4,
    JAX's random VGG weights carried across): loss within rtol 1e-5 and
    every gradient within rtol 1e-4, atol 1e-5 of its largest entry, the
    bars of the step above."""
    model, params, batch = setup
    vgg = jax.tree_util.tree_map(np.asarray, jvgg.random_params(
        jax.random.key(0), 35))
    lcfg = dict(perceptual_weight=0.1)
    jl = JaxLoss(JaxLossConfig(**lcfg), vgg)
    (jloss, jcomps), jg = jax.jit(jax.value_and_grad(
        lambda p: jl(model.apply({"params": p}, batch["lr"]), batch["hr"],
                     batch["weight"]), has_aux=True))(params)
    m = _port(params)
    tb = _tb(batch)
    loss_fn = CombinedLoss(LossConfig(**lcfg),
                           vgg_mod.VGG19Features.from_params(vgg, 35))
    loss, comps, grads = trainer.loss_and_grads(m, loss_fn, tb["hr"],
                                                tb["lr"], tb["weight"])
    np.testing.assert_allclose(float(comps["perceptual_loss"]),
                               float(jcomps["perceptual_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _leaves(_tree(dict(zip([n for n, _ in m.named_parameters()],
                                 grads))))
    want = _leaves(jg)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's jitted train step with grad_accum 2 and an EMA of 0.9, its
    losses over 3 steps from the fixture's params, and the state after."""
    model, params, batch = setup
    opt = jtrain.make_optimizer(WD)
    step = jax.jit(jtrain.build_train_step(
        model, JaxLoss(JaxLossConfig()), opt, None, JaxLossConfig(),
        grad_accum=2, ema_decay=0.9))
    st = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=opt.init(params), ema_params=params)
    losses = []
    for _ in range(3):
        st, met = step(st, batch, jnp.float32(LR_), jax.random.key(0))
        losses.append(float(met["loss"]))
    return step, losses, jax.tree_util.tree_map(np.asarray, st)


def _port_steps(params, batch, ga, ema, n=3):
    m = _port(params)
    opt = trainer.make_optimizer(m.parameters(), LR_, WD)
    st = trainer.TrainState(m, opt, 0, {k: p.detach().clone() for k, p in
                                        m.named_parameters()} if ema else None)
    step = trainer.build_train_step(CombinedLoss(LossConfig()), None, ga, ema)
    losses = [float(step(st, _tb(batch), LR_)["loss"]) for _ in range(n)]
    return losses, st


@pytest.mark.parametrize("ga", [1, 2])
def test_three_steps_match_jax(setup, jax_steps, ga):
    """Three steps of the port's train step (grad_accum 1 and 2, EMA 0.9)
    against JAX's ``build_train_step`` with grad_accum 2 (exact, so equal
    to its grad_accum 1 to rounding): losses within rtol 1e-5, Adam's count
    equal, and params, both moments and the EMA within 5e-5 relative L2 a
    tensor. Adam divides each first moment by the root of the second, so
    at an element whose gradient cancels across steps the small difference
    between the two packages' conv gradients grows to a share of one
    step's lr; elementwise rtol 1e-5 does not hold there, and
    test_optimizer_and_ema_match_optax_on_the_ports_gradients checks the
    update rule alone."""
    _, params, batch = setup
    _, jlosses, jst = jax_steps
    losses, st = _port_steps(params, batch, ga, 0.9)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    adam = trainer.adam_state(st.model, st.optimizer)
    assert adam["count"] == int(jst.opt_state[1].count) == st.step == 3
    for got, want in ((_tree(st.model.state_dict()), jst.params),
                      (_tree(adam["mu"]), jst.opt_state[1].mu),
                      (_tree(adam["nu"]), jst.opt_state[1].nu),
                      (_tree(st.ema), jst.ema_params)):
        err, key = _max_rel(got, want)
        assert err <= 5e-5, (key, err)


def test_optimizer_and_ema_match_optax_on_the_ports_gradients(setup):
    """The update rule alone, with the gradient noise between the packages
    taken out: optax's (add_decayed_weights, scale_by_adam) chain and
    JAX's EMA, fed the port's own gradients, give the port's params,
    moments and EMA within rtol 1e-5, the bar tests/test_train.py:80 sets
    for torch Adam against that chain (atol 1e-4 of one step's lr for the
    params and the EMA, 1e-6 of the largest entry for the moments)."""
    _, params, batch = setup
    m = _port(params)
    opt = trainer.make_optimizer(m.parameters(), LR_, WD)
    st = trainer.TrainState(m, opt, 0, {k: p.detach().clone() for k, p in
                                        m.named_parameters()})
    step = trainer.build_train_step(CombinedLoss(LossConfig()), None, 1, 0.9)
    names = [n for n, _ in m.named_parameters()]
    jopt = jtrain.make_optimizer(WD)

    @jax.jit
    def jax_update(g, state, p, ema):
        updates, state = jopt.update(g, state, p)
        p = optax.apply_updates(
            p, jax.tree_util.tree_map(lambda u: -LR_ * u, updates))
        return state, p, jax.tree_util.tree_map(
            lambda e, q: e * 0.9 + q * (1.0 - 0.9), ema, p)

    jp = _tree(m.state_dict())
    jstate, jema = jopt.init(jp), jp
    tb = _tb(batch)
    for _ in range(3):
        _, _, grads = trainer.loss_and_grads(
            m, CombinedLoss(LossConfig()), tb["hr"], tb["lr"], tb["weight"])
        jstate, jp, jema = jax_update(_tree(dict(zip(names, grads))), jstate,
                                      jp, jema)
        step(st, tb, LR_)       # the same deterministic gradients
    adam = trainer.adam_state(m, opt)
    for got, want, atol in ((_tree(m.state_dict()), jp, None),
                            (_tree(adam["mu"]), jstate[1].mu, 1e-6),
                            (_tree(adam["nu"]), jstate[1].nu, 1e-6),
                            (_tree(st.ema), jema, None)):
        g, w = _leaves(got), _leaves(want)
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], rtol=1e-5, err_msg=k,
                atol=1e-4 * LR_ if atol is None else
                atol * np.abs(w[k]).max())


def test_grad_accum_equals_full_batch_in_the_port(setup):
    _, params, batch = setup
    m = _port(params)
    tb = _tb(batch)
    fn = CombinedLoss(LossConfig())
    l1, c1, g1 = trainer.loss_and_grads(m, fn, tb["hr"], tb["lr"],
                                        tb["weight"])
    l2, c2, g2 = trainer.loss_and_grads(m, fn, tb["hr"], tb["lr"],
                                        tb["weight"], grad_accum=2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    np.testing.assert_allclose(float(c2["ssim_metric"]),
                               float(c1["ssim_metric"]), rtol=1e-6)
    assert float(c2["ssim_clip_micros"]) == 0.0
    for a, b in zip(g2, g1):
        assert _rel(a, b) <= 1e-5


def test_training_after_serving_in_one_process():
    """The resize matrices and the SSIM window are cached per shape; when
    serving (under inference mode) makes them first, a training step in
    the same process must still differentiate through them."""
    from mri_superresolution_torch.infer import InferenceEngine
    sd = build_model(ModelConfig(base_filters=16)).state_dict()
    eng = InferenceEngine(ModelConfig(base_filters=16), sd, bf16=False,
                          device="cpu")
    rng = np.random.default_rng(9)
    eng.upscale_batch(rng.random((2, 20, 28)).astype(np.float32))
    m = build_model(ModelConfig(base_filters=16))
    m.load_state_dict(sd)
    loss, _, grads = trainer.loss_and_grads(
        m, CombinedLoss(LossConfig()),
        torch.from_numpy(rng.random((2, 40, 56, 1), np.float32)),
        torch.from_numpy(rng.random((2, 20, 28, 1), np.float32)),
        torch.ones(2))
    assert np.isfinite(float(loss)) and all(g.abs().sum() > 0 for g in grads)


# ----------------------------------------------------------- checkpoints

def test_port_checkpoint_loads_in_jax(setup, tmp_path):
    """A port-written checkpoint (after two steps, with EMA) loads in the
    JAX package's load_checkpoint with an optax template: params (the EMA),
    Adam's count and moments, and the live weights, all equal."""
    _, params, batch = setup
    _, st = _port_steps(params, batch, 1, 0.9, n=2)
    adam = trainer.adam_state(st.model, st.optimizer)
    live = st.model.state_dict()
    base = str(tmp_path / "final_model_unet")
    ckpt.save_checkpoint(base, st.ema, adam, meta={"step": 2},
                         extras={"raw_params": live})
    opt = jtrain.make_optimizer(WD)
    jp, jopt, meta, extras = jax_ckpt.load_checkpoint(
        base + ".ckpt", opt_state_template=opt.init(params),
        return_extras=True)
    assert meta == {"step": 2} and int(jopt[1].count) == 2
    for got, want in ((jp, _tree(st.ema)), (jopt[1].mu, _tree(adam["mu"])),
                      (jopt[1].nu, _tree(adam["nu"])),
                      (extras["raw_params"], _tree(live))):
        g, w = _leaves(got), _leaves(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    # and back into the port, unchanged
    p2, o2, _, e2 = ckpt.load_checkpoint(base + ".ckpt", return_extras=True)
    assert o2["count"] == 2
    for k, v in live.items():
        assert torch.equal(e2["raw_params"][k], v)
        assert torch.equal(o2["mu"][k], adam["mu"][k].reshape(v.shape))


def test_jax_checkpoint_resumes_in_the_port(setup, jax_steps, tmp_path):
    """A checkpoint the JAX package wrote after its steps (params and optax
    state) resumes in the port: the arrays load unchanged, and the port's
    next step matches JAX's next step."""
    model, params, batch = setup
    jstep, _, jst = jax_steps
    base = str(tmp_path / "final_model_unet")
    jax_ckpt.save_checkpoint(base, jst.params, jst.opt_state,
                             meta={"step": 3})
    sd, opt_r, meta, _ = ckpt.load_checkpoint(base + ".ckpt",
                                              return_extras=True)
    m = build_model(ModelConfig(base_filters=16, initial_alpha=ALPHA))
    m.load_state_dict(sd)
    opt = trainer.make_optimizer(m.parameters(), LR_, WD)
    trainer.load_adam_state(m, opt, opt_r)
    adam = trainer.adam_state(m, opt)
    assert adam["count"] == 3 and meta["step"] == 3
    for got, want in ((_tree(m.state_dict()), jst.params),
                      (_tree(adam["mu"]), jst.opt_state[1].mu),
                      (_tree(adam["nu"]), jst.opt_state[1].nu)):
        g, w = _leaves(got), _leaves(want)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    # one more step on both sides, from the same state
    jst2, jmet = jstep(jst, batch, jnp.float32(LR_), jax.random.key(0))
    st = trainer.TrainState(m, opt, 3, None)
    met = trainer.build_train_step(CombinedLoss(LossConfig()), None, 2)(
        st, _tb(batch), LR_)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    err, key = _max_rel(_tree(m.state_dict()), jst2.params)
    assert err <= 5e-5, (key, err)


# ------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """16 phantom pairs (LR 16², HR 32²) of 4 subjects, written by the
    port's PNG encoder."""
    d = tmp_path_factory.mktemp("pngs")
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


def _argv(pngs, ckdir, *extra):
    return ["--full_res_dir", str(pngs / "hr"), "--low_res_dir",
            str(pngs / "lr"), "--base_filters", "16", "--batch_size", "4",
            "--seed", "3", "--cpu", "--checkpoint_dir", str(ckdir),
            "--log_dir", str(ckdir / "logs"), *extra]


def _final(path):
    sd, opt, meta = ckpt.load_checkpoint(path)
    return sd, opt, meta


def _assert_same(a, b):
    (sa, oa, _), (sb, ob, _) = a, b
    assert oa["count"] == ob["count"]
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
        assert torch.equal(oa["mu"][k], ob["mu"][k]), k
        assert torch.equal(oa["nu"][k], ob["nu"][k]), k


def test_cli_two_epochs_equal_one_plus_resume(pngs, tmp_path, capsys):
    """2 epochs in one run equal 1 epoch and a --resume of 1, bit for bit;
    the run speaks the JSON-line protocol and writes best and final
    checkpoints whose sidecar the JAX package reads."""
    a = cli.main(_argv(pngs, tmp_path / "a", "--epochs", "2"))
    out = capsys.readouterr().out
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    types = [ln["type"] for ln in lines]
    assert types.count("params") == 1 and types.count("epoch_summary") == 2
    assert "batch_update" in types
    summaries = [ln for ln in lines if ln["type"] == "epoch_summary"]
    assert all(np.isfinite(s["train_loss"]) and np.isfinite(s["val_loss"])
               for s in summaries)
    for name in ("best_model_unet", "final_model_unet"):
        assert os.path.exists(tmp_path / "a" / f"{name}.ckpt")
    meta = json.load(open(tmp_path / "a" / "final_model_unet.json"))
    jcfg = __import__("mri_superresolution_tpu.config", fromlist=["x"])
    assert jcfg.train_config_from_dict(meta["config"]).model.base_filters \
        == 16

    cli.main(_argv(pngs, tmp_path / "b", "--epochs", "1"))
    b = cli.main(_argv(pngs, tmp_path / "b", "--epochs", "2", "--resume"))
    out = capsys.readouterr().out
    assert "Resumed from" in out
    _assert_same(_final(a), _final(b))


def test_cli_runs_from_one_seed_are_bit_equal(pngs, tmp_path):
    """Two train CLI runs from one seed on the same pairs, with other work
    between them, give the same parameters and Adam moments bit for bit:
    the repeatability the card's phase checks (``chip_smoke.py``
    ``train_repeat``), as the JAX trainer is seed-deterministic."""
    a = cli.main(_argv(pngs, tmp_path / "a", "--epochs", "1"))
    with torch.no_grad():
        build_model(ModelConfig(base_filters=16))(torch.rand(3, 24, 24, 1))
    b = cli.main(_argv(pngs, tmp_path / "b", "--epochs", "1"))
    _assert_same(_final(a), _final(b))


def test_repeatable_scopes_the_cudnn_flags():
    """The trainer's step runs with cuDNN restricted to deterministic,
    untuned algorithms and gives the caller's flags back after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    seen = []
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        with trainer.repeatable():
            seen.append((cudnn.deterministic, cudnn.benchmark))
        assert seen == [(True, False)]
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        with pytest.raises(RuntimeError):
            with trainer.repeatable():
                raise RuntimeError("inside")
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def test_cli_step_checkpoint_resumes_mid_epoch(pngs, tmp_path, capsys):
    """A --save_every_steps checkpoint resumes inside the epoch bit for bit,
    augmentation on (tests/test_train.py:465 pins the same for JAX)."""
    # 13 training pairs: 4 batches an epoch; the step checkpoint of step 3
    # has the cursor 3 of epoch 0, and the run stops at epoch 1's start
    extra = ("--epochs", "2", "--augmentation", "--save_every_steps", "3",
             "--ema_decay", "0.5")
    a = cli.main(_argv(pngs, tmp_path / "a", *extra))

    def boom(epoch, batch_idx, loss):
        if epoch == 1:
            raise RuntimeError("simulated preemption")

    cfg = cli.config_from_args(cli.parse_args(_argv(pngs, tmp_path / "b",
                                                    *extra)))
    with pytest.raises(RuntimeError, match="simulated preemption"):
        trainer.train(cfg, progress_cb=boom, device="cpu")
    step_meta = json.load(open(tmp_path / "b" / "step_model_unet.json"))
    assert (step_meta["epoch"], step_meta["batch_cursor"]) == (0, 3)
    capsys.readouterr()
    b = cli.main(_argv(pngs, tmp_path / "b", *extra, "--resume"))
    assert "mid-epoch" in capsys.readouterr().out
    _assert_same(_final(a), _final(b))
    # the EMA serving params as well, and no stale step checkpoint
    ea = ckpt.load_checkpoint(a, return_extras=True)[3]["raw_params"]
    eb = ckpt.load_checkpoint(b, return_extras=True)[3]["raw_params"]
    assert all(torch.equal(ea[k], eb[k]) for k in ea)
    for d in ("a", "b"):
        assert not os.path.exists(tmp_path / d / "step_model_unet.ckpt")


def test_cli_checkpoint_serves_in_the_port(pngs, tmp_path):
    path = cli.main(_argv(pngs, tmp_path, "--epochs", "1"))
    from mri_superresolution_torch.config import InferConfig
    from mri_superresolution_torch.infer import load_engine
    eng = load_engine(InferConfig(checkpoint_path=path, bf16=False),
                      device="cpu")
    assert eng.model_cfg.base_filters == 16
    out = eng.upscale_batch(np.random.default_rng(0).random(
        (2, 16, 16)).astype(np.float32))
    assert out.shape == (2, 32, 32) and np.isfinite(out).all()


@pytest.mark.parametrize("family,flags", [
    ("edsr", ("--num_blocks", "2")), ("unet_tpu", ()), ("simple", ()),
    ("unet", ("--perceptual_weight", "0.1")),
    ("unet", ("--perceptual_weight", "0.1", "--vgg_layer_idx", "8",
              "--perceptual_loss_type", "mse", "--vgg_weights", "VGG"))])
def test_cli_trains_every_family_and_the_perceptual_loss(
        pngs, tmp_path, capsys, family, flags):
    """One epoch of the train CLI for each family and with the perceptual
    term (seeded random VGG weights with the JAX trainer's warning, or an
    ``.npz`` given by --vgg_weights): finite losses, a checkpoint of the
    family whose sidecar carries the flags, served by ``load_engine``."""
    if "VGG" in flags:
        npz = str(tmp_path / "vgg.npz")
        vgg_mod.save_params_npz(npz, vgg_mod.random_params(
            torch.Generator().manual_seed(1), 8))
        flags = tuple(npz if f == "VGG" else f for f in flags)
    path = cli.main(_argv(pngs, tmp_path, "--epochs", "1", "--model_type",
                          family, *flags))
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    summary = [ln for ln in lines if ln["type"] == "epoch_summary"][0]
    assert np.isfinite(summary["train_loss"]) and \
        np.isfinite(summary["val_loss"])
    warned = any("RANDOM VGG" in ln.get("message", "") for ln in lines)
    loaded = any("Loaded VGG19" in ln.get("message", "") for ln in lines)
    assert (warned, loaded) == ("--perceptual_weight" in flags
                                and "--vgg_weights" not in flags,
                                "--vgg_weights" in flags)
    assert path == str(tmp_path / f"final_model_{family}.ckpt")
    cfg = ckpt.read_meta(path)["config"]
    assert cfg["model"]["model_type"] == family
    if family == "edsr":
        assert cfg["model"]["num_blocks"] == 2
    if "--perceptual_weight" in flags:
        assert cfg["loss"]["perceptual_weight"] == 0.1
        assert cfg["loss"]["vgg_layer_idx"] == (8 if loaded else 35)
        assert cfg["loss"]["perceptual_loss_type"] == ("mse" if loaded
                                                       else "l1")
    from mri_superresolution_torch.config import InferConfig
    from mri_superresolution_torch.infer import load_engine
    eng = load_engine(InferConfig(checkpoint_path=path, bf16=False),
                      device="cpu")
    assert eng.model_cfg.model_type == family
    out = eng.upscale_batch(np.random.default_rng(0).random(
        (2, 16, 16)).astype(np.float32))
    assert out.shape == (2, 32, 32) and np.isfinite(out).all()


@pytest.mark.parametrize("flags", [("--qat", "--spatial_shards", "2"),
                                   ("--spatial_shards", "2")])
def test_cli_runs_spatial_modes(pngs, tmp_path, monkeypatch, flags):
    """``--spatial_shards 2`` (with ``--qat`` too) over two CPU ranks
    trains row-sharded: the final checkpoint, rank 0's log with the
    spatial mesh's line and, under QAT, the sidecar of 20 frozen scales
    (the JAX package's ``test_qat_spatial_train_end_to_end``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    final = cli.main(_argv(pngs, tmp_path, "--epochs", "1", "--num_devices",
                           "2", *flags))
    assert os.path.exists(final)
    log = (tmp_path / "logs" / "training.log").read_text()
    assert "Spatially-sharded training: (1 data x 2 space) mesh" in log
    if "--qat" in flags:
        assert "QAT enabled" in log
        scales, mtype = qf.load_scales(final[:-len(".ckpt")] + ".calib.json")
        assert mtype == "unet" and len(scales) == 20
