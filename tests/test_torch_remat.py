"""The train CLI's one-card A14 flags on the CPU: ``--remat`` (the JAX
package's remat blocks recomputed in the backward through
``torch.utils.checkpoint``) against the port's step without it and
against JAX's ``remat=True`` step, and ``--profile_dir``'s trace. Small
sizes: base filters 16 (the unet's narrowest GroupNorm(8) stage is f/2),
edsr 2 blocks, LR 16² → HR 32², batch 4 with a padding row of weight 0,
fp32."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import LossConfig as JaxLossConfig
from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
from mri_superresolution_tpu.models import build_model as jax_build_model
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.train import trainer as jtrain
from mri_superresolution_torch import native
from mri_superresolution_torch.cli import train as cli
from mri_superresolution_torch.config import LossConfig, ModelConfig
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model, edsr, vgg
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

torch.set_num_threads(2)

LR_, WD = 1e-4, 1e-5
ALPHA = 25.0
FAMILIES = ("unet", "unet_tpu", "edsr")
# a forward's kernel sites: B1 (GroupNorm+LeakyReLU) and B3 (narrow conv)
SITES = {"unet": (20, 2), "unet_tpu": (20, 0), "edsr": (0, 0)}
_GN = sys.modules["mri_superresolution_torch.kernels.groupnorm"]
_C3 = sys.modules["mri_superresolution_torch.kernels.conv3x3"]


def _cfg(family):
    return ModelConfig(model_type=family, base_filters=16, num_blocks=2,
                       initial_alpha=ALPHA)


def _batch():
    return {"lr": phantom_batch(np.random.default_rng(0), 4, 16)[..., None],
            "hr": phantom_batch(np.random.default_rng(0), 4, 32)[..., None],
            "weight": np.array([1, 1, 1, 0], np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture
def counted(monkeypatch):
    """Calls of B1's and B3's forward (their plain versions here; on the
    card each is one kernel launch) and of edsr's ResBlock forward."""
    calls = {"b1": 0, "b3": 0, "resblock": 0}

    def wrap(module, name, key):
        fn = getattr(module, name)

        def counting(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counting)

    wrap(_GN, "_forward", "b1")
    wrap(_C3, "_forward", "b3")
    wrap(edsr.ResBlock, "forward", "resblock")
    return calls


def _port_steps(family, remat, params=None, loss_cfg=LossConfig(),
                vgg_fn=None, n=3):
    """``n`` steps of the port's train step from ``params`` (a state_dict;
    else the seeded init): the model and Adam's state after them."""
    m = build_model(_cfg(family), generator=torch.Generator().manual_seed(0),
                    remat=remat)
    if params is not None:
        m.load_state_dict(params)
    st = trainer.TrainState(m, trainer.make_optimizer(m.parameters(), LR_,
                                                      WD))
    step = trainer.build_train_step(CombinedLoss(loss_cfg, vgg_fn,
                                                 remat=remat))
    b = _tb(_batch())
    losses = [float(step(st, b, LR_)["loss"]) for _ in range(n)]
    return losses, st.model.state_dict(), trainer.adam_state(st.model,
                                                             st.optimizer)


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_update_is_bit_equal_and_recomputes_the_blocks(family,
                                                             counted):
    """Three steps with ``remat`` give the same bits as without it (loss,
    params, both moments), and the backward runs each remat block's
    forward once more: every B1 and B3 site of the unets (a kernel saves
    its inputs only when its forward returns, so PyTorch's early stop
    does not skip a segment's last kernel) and each edsr ResBlock."""
    plain = _port_steps(family, False)
    once = dict(counted)
    counted.update(b1=0, b3=0, resblock=0)
    remat = _port_steps(family, True)
    assert plain[0] == remat[0]
    for k, v in plain[1].items():
        assert torch.equal(v, remat[1][k]), k
    for key in ("mu", "nu"):
        for k, v in plain[2][key].items():
            assert torch.equal(v, remat[2][key][k]), (key, k)
    b1, b3 = SITES[family]
    blocks = 2 if family == "edsr" else 0
    assert once == {"b1": 3 * b1, "b3": 3 * b3, "resblock": 3 * blocks}
    assert counted == {"b1": 6 * b1, "b3": 6 * b3, "resblock": 6 * blocks}


def test_remat_of_the_perceptual_term_is_bit_equal():
    """With the VGG19 term the loss-graph checkpoint recomputes the
    output's features in the backward: the same update bits."""
    lcfg = LossConfig(perceptual_weight=0.1, vgg_layer_idx=8)
    feats = vgg.VGG19Features.from_params(
        vgg.random_params(torch.Generator().manual_seed(0), 8), 8)
    plain = _port_steps("unet", False, loss_cfg=lcfg, vgg_fn=feats, n=2)
    remat = _port_steps("unet", True, loss_cfg=lcfg, vgg_fn=feats, n=2)
    assert plain[0] == remat[0]
    for k, v in plain[1].items():
        assert torch.equal(v, remat[1][k]), k


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_steps_match_jax_remat(family):
    """Three steps of the port with ``remat`` against JAX's jitted
    ``build_train_step`` of ``build_model(..., remat=True)`` with its
    loss-graph checkpoint, from the same params: losses within rtol 1e-5,
    params and both moments within 5e-5 relative L2 a tensor: the
    training parity of tests/test_torch_train.py, on its setup (the unets'
    fusion weight at 25%). At a fusion weight of 0 one bias of the unet
    (``up1.conv.norm1``), whose gradient cancels across the steps, moves
    by 4.6e-4 between the packages with and without remat alike, and by
    6.9e-5 between JAX's own remat and plain steps: Adam's update there is
    a share of the lr, whatever the rounding."""
    cfg = JaxModelConfig(model_type=family, base_filters=16, num_blocks=2,
                         initial_alpha=ALPHA)
    model = jax_build_model(cfg, remat=True)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(model, jax.random.key(0), (16, 16)))
    opt = jtrain.make_optimizer(WD)
    step = jax.jit(jtrain.build_train_step(
        model, JaxLoss(JaxLossConfig()), opt, None, JaxLossConfig(),
        remat=True))
    st = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=opt.init(params), ema_params=None)
    batch = _batch()
    jlosses = []
    for _ in range(3):
        st, met = step(st, batch, jnp.float32(LR_), jax.random.key(0))
        jlosses.append(float(met["loss"]))
    losses, sd, adam = _port_steps(family, True,
                                   state_dict_from_jax(params, family))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert adam["count"] == int(st.opt_state[1].count) == 3
    for got, want in ((sd, st.params), (adam["mu"], st.opt_state[1].mu),
                      (adam["nu"], st.opt_state[1].nu)):
        got = jax_params_from_state_dict(got, family)
        la = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_leaves_with_path(got)}
        lb = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_leaves_with_path(want)}
        assert sorted(la) == sorted(lb)
        err, key = max((_rel(la[k], lb[k]), k) for k in la)
        assert err <= 5e-5, (key, err)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """12 phantom pairs (LR 16², HR 32²) of 3 subjects."""
    d = tmp_path_factory.mktemp("pngs")
    hr = phantom_batch(np.random.default_rng(1), 12, 32)
    lr = phantom_batch(np.random.default_rng(1), 12, 16)
    for sub in ("hr", "lr"):
        (d / sub).mkdir()
    for i in range(12):
        name = f"sub-{i // 4:02d}_T1w_s{i:03d}.png"
        native.imwrite_gray(str(d / "hr" / name),
                            np.round(hr[i] * 255).astype(np.uint8))
        native.imwrite_gray(str(d / "lr" / name),
                            np.round(lr[i] * 255).astype(np.uint8))
    return d


def _argv(pngs, ckdir, *extra):
    return ["--full_res_dir", str(pngs / "hr"), "--low_res_dir",
            str(pngs / "lr"), "--base_filters", "16", "--batch_size", "4",
            "--epochs", "2", "--seed", "3", "--cpu", "--checkpoint_dir",
            str(ckdir), "--log_dir", str(ckdir / "logs"), *extra]


def test_cli_remat_checkpoint_is_the_same_bytes(pngs, tmp_path, capsys):
    """The train CLI with ``--remat`` writes the same final ``.ckpt``
    bytes (parameters and Adam's state) as without it, and a sidecar that
    differs only in its ``remat`` field."""
    a = cli.main(_argv(pngs, tmp_path / "plain"))
    b = cli.main(_argv(pngs, tmp_path / "remat", "--remat"))
    capsys.readouterr()
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    ma, mb = ckpt.read_meta(a), ckpt.read_meta(b)
    assert (ma["config"]["remat"], mb["config"]["remat"]) == (False, True)
    for m in (ma, mb):
        m["config"].pop("remat")
        for k in ("checkpoint_dir", "log_dir"):
            m["config"].pop(k)
    assert ma == mb


def test_cli_profile_dir_writes_a_trace_of_one_epoch(pngs, tmp_path, capsys):
    """``--profile_dir`` traces the epoch the JAX trainer traces
    (``min(start_epoch + 1, epochs - 1)``: here epoch 1 of 2) into a
    Chrome trace there, and says so."""
    prof = tmp_path / "prof"
    cli.main(_argv(pngs, tmp_path / "ck", "--profile_dir", str(prof)))
    out = capsys.readouterr().out
    assert os.listdir(prof) == ["trace_epoch1.json"]
    with open(prof / "trace_epoch1.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]
    assert f"Wrote profiler trace to {prof}" in out
