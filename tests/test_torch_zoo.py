"""The port's other model families (``unet_tpu``, ``edsr``, ``simple``)
against the JAX package, on the CPU, at a small size: base filters 8, edsr
2 blocks, 32^2 and 27 x 35 inputs. Each family's JAX params (its init
with every leaf moved by seeded numpy noise, so that edsr's zero-init
convs and the zero biases carry information) go to the port through
``utils.weights``; inputs come from numpy seeds."""

import dataclasses
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import LossConfig as JaxLossConfig
from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
from mri_superresolution_tpu.models import build_model as jax_build_model
from mri_superresolution_tpu.models import param_count as jax_param_count
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.ops import metrics as jmetrics
from mri_superresolution_tpu.ops.ssim import ssim as jax_ssim
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_torch.config import (InferConfig, LossConfig,
                                              ModelConfig, to_dict)
from mri_superresolution_torch.infer import InferenceEngine, load_engine
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model, param_count
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.models import unet as unet_mod
from mri_superresolution_torch.ops.functional import group_norm_fp32
from mri_superresolution_torch.ops.metrics import psnr
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

torch.set_num_threads(2)

FAMILIES = ("unet_tpu", "edsr", "simple")
ALPHA = 25.0


def _cfg(family):
    return dict(model_type=family, base_filters=8, num_blocks=2,
                initial_alpha=ALPHA)


def _jax_model(family, dtype=jnp.float32):
    return jax_build_model(JaxModelConfig(**_cfg(family)), dtype=dtype)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return request.param


_PARAMS = {}


def jax_params_of(family):
    """The family's JAX init (key 0), every leaf moved by 5% noise."""
    if family not in _PARAMS:
        p = _jax_model(family).init(jax.random.key(0),
                                    jnp.zeros((1, 32, 32, 1)))["params"]
        rng = np.random.default_rng(1)

        def move(v):
            v = np.asarray(v, np.float32)
            scale = float(np.abs(v).mean()) or 1.0
            return (v + 0.05 * scale * rng.standard_normal(v.shape)).astype(
                np.float32)

        _PARAMS[family] = jax.tree_util.tree_map(move, p)
    return _PARAMS[family]


def _port(family, dtype=torch.float32):
    m = build_model(ModelConfig(**_cfg(family)), dtype=dtype)
    m.load_state_dict(state_dict_from_jax(jax_params_of(family), family),
                      strict=True)
    return m.eval()


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _db(a, b):
    return float(psnr(torch.tensor(np.asarray(a)),
                      torch.tensor(np.asarray(b))))


# ------------------------------------------------------------ weights

def test_weights_round_trip_exact(family):
    p = jax_params_of(family)
    sd = state_dict_from_jax(p, family)
    assert set(sd) == set(build_model(ModelConfig(**_cfg(family)))
                          .state_dict())
    got, want = _leaves(jax_params_from_state_dict(sd, family)), _leaves(p)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.reshape(got[k].shape),
                                      err_msg=k)


def test_param_count_matches_jax(family):
    assert param_count(build_model(ModelConfig(**_cfg(family)))) == \
        jax_param_count(jax_params_of(family))


def test_tree_of_another_family_raises():
    with pytest.raises(ValueError, match="does not fit model type 'unet'"):
        state_dict_from_jax(jax_params_of("edsr"), "unet")
    with pytest.raises(ValueError, match="unet_tpu"):
        state_dict_from_jax(jax_params_of("simple"), "unet_tpu")


def test_init_is_seeded():
    """Seeded kaiming fan-out init; ICNR on unet_tpu's branch B (each
    sub-band repeated 4 times); edsr's residual convs at zero."""
    for family in FAMILIES:
        a = build_model(ModelConfig(**_cfg(family)),
                        generator=torch.Generator().manual_seed(0))
        b = build_model(ModelConfig(**_cfg(family)),
                        generator=torch.Generator().manual_seed(0))
        for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(u, v), (family, k)
    m = build_model(ModelConfig(model_type="unet_tpu", base_filters=16,
                                initial_alpha=50.0))
    w = m.branch_b_conv.weight                       # (32, 16, 3, 3)
    for o in range(0, 32, 4):
        for k in range(1, 4):
            assert torch.equal(w[o], w[o + k])
    assert abs(float(m.alpha.detach()) - 0.5) < 1e-6
    want_std = (2.0 / (1 + 0.01 ** 2) / (32 * 9)) ** 0.5
    assert abs(float(m.head_conv.weight.detach().std()) / want_std - 1) < 0.05
    e = build_model(ModelConfig(model_type="edsr", base_filters=16,
                                num_blocks=3))
    for i in range(3):
        assert not getattr(e, f"block{i}").conv1.weight.any()
        assert getattr(e, f"block{i}").conv0.weight.any()


# -------------------------------------------------------------- forward

@pytest.mark.parametrize("hw", [(32, 32), (27, 35)])
def test_forward_fp32_matches_jax(family, hw):
    x = np.random.default_rng(0).random((2,) + hw + (1,), dtype=np.float32)
    want = np.asarray(_jax_model(family).apply(
        {"params": jax_params_of(family)}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(family)(torch.from_numpy(x))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_forward_bf16_within_metric_budget(family):
    """The bf16 forwards against one ground truth within the 0.1 dB and
    1e-3 SSIM budget of tests/test_unet.py (bf16 rounds at other places
    in the two frameworks)."""
    rng = np.random.default_rng(1)
    x = rng.random((2, 27, 35, 1), dtype=np.float32)
    gt = jnp.asarray(rng.random((2, 54, 70, 1), dtype=np.float32))
    want = _jax_model(family, jnp.bfloat16).apply(
        {"params": jax_params_of(family)}, jnp.asarray(x))
    with torch.no_grad():
        got = _port(family, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = jnp.asarray(got.numpy())
    assert abs(float(jmetrics.psnr(got, gt))
               - float(jmetrics.psnr(want, gt))) <= 0.1
    assert abs(float(jax_ssim(got, gt)) - float(jax_ssim(want, gt))) <= 1e-3


# ---------------------------------------------------------------- int8

N_SITES = {"unet_tpu": 20, "edsr": 6, "simple": 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ref_forward_bit_identical_to_model(family, dtype):
    model = _port(family, dtype)
    x = torch.from_numpy(np.random.default_rng(8).random((2, 40, 48, 1),
                                                         np.float32))
    with torch.inference_mode():
        want = model(x)
        assert torch.equal(qf.reference_forward(model.state_dict(), x,
                                                family, dtype), want)
        y, amax = qf.build_calib_forward(family, dtype)(model.state_dict(), x)
    assert torch.equal(y, want)
    assert len(amax) == N_SITES[family] and qf.OUT_SITE not in amax


def test_quant_sites_match_jax(family):
    sd = _port(family).state_dict()
    got = qf.quant_sites(sd, family)
    want = jqf.quant_sites(jax_params_of(family), family)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert len(got) == N_SITES[family]
    for (site, w), (_, k) in zip(got, want):
        np.testing.assert_array_equal(w.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(k), err_msg=site)


def test_calib_scales_match_jax(family):
    """fp32 calibration scales within rtol 1e-4 (sums in other orders)."""
    x = phantom_batch(np.random.default_rng(0), 2, 40)[..., None]
    want = jqf.calibrate(jax_params_of(family), [x], family,
                         dtype=jnp.float32)
    with torch.inference_mode():
        _, amax = qf.build_calib_forward(family, torch.float32)(
            _port(family).state_dict(), torch.from_numpy(x))
    got = qf.scales_from_amax({k: v.numpy() for k, v in amax.items()})
    assert list(got) == list(want) and len(got) == N_SITES[family]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_int8_forward_matches_jax_with_shared_scales(family):
    """JAX's scales in both packages' int8 forwards: within JAX's own int8
    bound of each other, and within the bf16 budget against one ground
    truth, as tests/test_torch_quant.py holds the unet."""
    p = jax_params_of(family)
    x = phantom_batch(np.random.default_rng(0), 2, 40)[..., None]
    hr = phantom_batch(np.random.default_rng(0), 2, 80)[..., None]
    scales = jqf.calibrate(p, [x], family)
    jy = np.asarray(jax.jit(jqf.build_int8_forward(p, scales, family))(
        p, jnp.asarray(x)))
    fp32 = np.asarray(_jax_model(family).apply({"params": p},
                                               jnp.asarray(x)))
    sd = _port(family, torch.bfloat16).state_dict()
    with torch.inference_mode():
        y = qf.build_int8_forward(sd, scales, family)(sd, torch.from_numpy(x))
        ref = qf.reference_forward(sd, torch.from_numpy(x), family)
    y = y.numpy()
    assert y.shape == jy.shape == (2, 80, 80, 1)
    assert np.isfinite(y).all() and y.min() >= 0.0 and y.max() <= 1.0
    assert np.abs(y - ref.numpy()).mean() < 0.05
    assert np.abs(y - jy).mean() < 0.05
    assert abs(_db(y, hr) - _db(jy, hr)) <= 0.1
    assert _db(y, fp32) >= _db(jy, fp32) - 0.1


def test_int8_engine_serves_every_family(family, tmp_path):
    """The engine's int8 state machine on each family: calibrate, freeze
    and write the sidecar (with the family's name), serve int8; a second
    engine loads the sidecar and gives the same bytes."""
    sd = _port(family).state_dict()
    path = str(tmp_path / "scales.json")
    batch = phantom_batch(np.random.default_rng(2), 2, 24)
    kw = dict(device="cpu", quant="int8", quant_calib_slices=1,
              quant_calib_path=path)
    eng = InferenceEngine(ModelConfig(**_cfg(family)), sd, **kw)
    out = eng.upscale_batch(batch)
    assert eng._quant_batches == {"int8": 1, "bf16": 0}
    scales, saved = qf.load_scales(path)
    assert saved == family and len(scales) == N_SITES[family]
    again = InferenceEngine(ModelConfig(**_cfg(family)), sd, **kw)
    assert np.array_equal(again.upscale_batch(batch), out)
    assert out.shape == (2, 48, 48) and np.isfinite(out).all()


def test_unet_tpu_int8_warning_states_no_figure(caplog):
    """The engine warns on ``unet_tpu`` int8, as the JAX engine does, but
    states no time or rate (the JAX message's figure was a TPU's). caplog
    listens on the package logger itself: once a CLI in the same process
    has set up logging, that logger no longer propagates to the root."""
    logger = logging.getLogger("mri_superresolution_torch")
    propagate = logger.propagate
    logger.addHandler(caplog.handler)
    logger.propagate = False
    try:
        with caplog.at_level("WARNING", logger="mri_superresolution_torch"):
            InferenceEngine(ModelConfig(**_cfg("unet_tpu")),
                            _port("unet_tpu").state_dict(), device="cpu",
                            quant="int8")
    finally:
        logger.removeHandler(caplog.handler)
        logger.propagate = propagate
    msgs = [r.getMessage() for r in caplog.records if "unet_tpu" in
            r.getMessage()]
    assert len(msgs) == 1
    # no number but the digits of names such as int8 and bf16
    assert re.search(r"\b\d", msgs[0]) is None, msgs[0]


# ------------------------------------------------------------ training

def test_one_step_loss_and_grads_match_jax(family, monkeypatch):
    """One fp32 step of the default CombinedLoss (L1 + SSIM) at batch 4
    (a padding row of weight 0), LR 16^2 -> 32^2: loss within rtol 1e-5,
    every gradient within rtol 1e-4 and atol 1e-5 of its largest entry,
    the bars of tests/test_torch_train.py for the unet. For unet_tpu no
    GroupNorm output lies within two ulp of 1 of the LeakyReLU's kink,
    where the two packages may take the derivative from either side."""
    p = jax_params_of(family)
    batch = {"lr": phantom_batch(np.random.default_rng(0), 4, 16)[..., None],
             "hr": phantom_batch(np.random.default_rng(0), 4, 32)[..., None],
             "weight": np.array([1, 1, 1, 0], np.float32)}
    model = _jax_model(family)
    jl = JaxLoss(JaxLossConfig())
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda q: jl(model.apply({"params": q}, batch["lr"]), batch["hr"],
                     batch["weight"]), has_aux=True))(p)
    closest, gn = [], unet_mod.group_norm_leaky

    def spy(x, scale, bias, residual=None, n_groups=8, eps=1e-5):
        z = group_norm_fp32(x.detach(), scale.detach(), bias.detach(),
                            n_groups, eps)
        closest.append(float(z.abs().min()))
        return gn(x, scale, bias, residual=residual, n_groups=n_groups,
                  eps=eps)

    monkeypatch.setattr(unet_mod, "group_norm_leaky", spy)
    m = _port(family).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = trainer.loss_and_grads(
        m, CombinedLoss(LossConfig()), tb["hr"], tb["lr"], tb["weight"])
    if family == "unet_tpu":
        assert len(closest) == 20 and min(closest) > 2.4e-7, closest
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _leaves(jax_params_from_state_dict(
        dict(zip([n for n, _ in m.named_parameters()], grads)), family))
    want = _leaves(jg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.reshape(got[k].shape),
                                   rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)


# ---------------------------------------------------------- checkpoints

def _meta(family):
    return {"config": {"model": dataclasses.asdict(
        JaxModelConfig(**_cfg(family)))}, "step": 1}


def test_jax_checkpoint_serves_in_the_port(family, tmp_path):
    """A JAX-written checkpoint of the family is found by its name, served
    through ``load_engine`` (the family and its hyperparams from the
    sidecar, not the caller's defaults), fp32 within 1e-5 of JAX's
    ``model.apply`` (clamped)."""
    p = jax_params_of(family)
    jax_ckpt.save_checkpoint(str(tmp_path / f"best_model_{family}"), p,
                             meta=_meta(family))
    eng = load_engine(InferConfig(model=ModelConfig(model_type=family,
                                                    base_filters=64,
                                                    num_blocks=8),
                                  checkpoint_dir=str(tmp_path), bf16=False),
                      device="cpu")
    assert eng.model_cfg == ModelConfig(**_cfg(family))
    x = np.random.default_rng(3).random((2, 24, 20), np.float32)
    want = np.clip(np.asarray(_jax_model(family).apply(
        {"params": p}, jnp.asarray(x[..., None])))[..., 0], 0.0, 1.0)
    np.testing.assert_allclose(eng.upscale_batch(x), want, rtol=1e-4,
                               atol=1e-5)


def test_port_checkpoint_loads_in_jax(family, tmp_path):
    """A port-written checkpoint (params and Adam's state after one step)
    loads in the JAX package's ``load_checkpoint`` leaf for leaf, and
    back into the port unchanged."""
    m = _port(family)
    opt = trainer.make_optimizer(m.parameters(), 1e-4, 1e-5)
    for q in m.parameters():
        q.grad = torch.ones_like(q)
    opt.step()
    adam = trainer.adam_state(m, opt)
    base = str(tmp_path / f"final_model_{family}")
    meta = {"config": {"model": to_dict(ModelConfig(**_cfg(family)))}}
    ckpt.save_checkpoint(base, m.state_dict(), adam, meta=meta)
    jp, _, jmeta = jax_ckpt.load_checkpoint(base + ".ckpt")
    assert jmeta["config"]["model"]["model_type"] == family
    want = _leaves(jax_params_from_state_dict(m.state_dict(), family))
    got = _leaves(jp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd, opt_r, _ = ckpt.load_checkpoint(base + ".ckpt")
    assert opt_r["count"] == 1
    for k, v in m.state_dict().items():
        assert torch.equal(sd[k], v), k
        if k in adam["mu"]:
            assert torch.equal(opt_r["mu"][k], adam["mu"][k].reshape(
                v.shape)), k
    assert os.path.exists(base + ".json")
