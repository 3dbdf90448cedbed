"""The port's row-sharded (spatial) training against the JAX package's, on
the CPU, over the in-process mesh.

The same seeded numpy batches and JAX's init (carried across with
``utils/weights.state_dict_from_jax``) go through JAX's
``parallel/spatial.build_spatial_loss`` and ``build_spatial_train_step``
on its CPU mesh and through the port's ``build_spatial_loss`` and
``train/trainer.build_spatial_train_step`` over an in-process
``SpatialMesh`` of the same shape. The bars are the JAX tests':
``tests/test_spatial.py:177-385`` (loss rtol 1e-5 and gradient max abs
1e-4; one step's loss rtol 1e-4, SSIM rtol 1e-3 atol 1e-5, params max
abs 2.5e-4 and 0.99-quantile 5e-5; ``--grad_accum 2`` against 1 and
``--remat`` against none) and ``tests/test_qat.py:554-650`` (the QAT
step). LR 64² over a (2, 4) grid, base filters 16, fp32.
"""

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
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.models import vgg as jvgg
from mri_superresolution_tpu.parallel import build_spatial_loss as jax_loss
from mri_superresolution_tpu.parallel import make_spatial_mesh as jax_mesh
from mri_superresolution_tpu.parallel import replicated_sharding
from mri_superresolution_tpu.train import trainer as jtrain
from mri_superresolution_torch.config import (LossConfig, ModelConfig,
                                              TrainConfig)
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import vgg as pvgg
from mri_superresolution_torch.parallel import spatial
from mri_superresolution_torch.tools import sp_step
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

torch.set_num_threads(2)
CPU = torch.device("cpu")
H = W = 64


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((n, H, W, 1), np.float32),
            "hr": rng.random((n, 2 * H, 2 * W, 1), np.float32),
            "weight": np.array([1, 1, 1, 0.0], np.float32)}


def jax_init(mt: str, seed: int) -> dict:
    """JAX's init of a base-filters-16 family, as numpy: ``model.init``
    jitted (one program, where the eager init compiles every op alone)."""
    model = jax_build_model(JaxModelConfig(model_type=mt, base_filters=16),
                            dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.key(seed), jnp.zeros((1, 32, 32, 1)))["params"])


@pytest.fixture(scope="module")
def families():
    """Per family: JAX's params (the JAX tests' seeds) and the port's
    state_dict of the same weights for the unets, which are held against
    JAX; the port's seeded init for edsr and simple, which are held
    against the port's dense autograd."""
    out = {mt: (p, state_dict_from_jax(p, mt)) for mt, p in
           (("unet", jax_init("unet", 0)),
            ("unet_tpu", jax_init("unet_tpu", 1)))}
    for mt in ("edsr", "simple"):
        out[mt] = (None, build_model(
            ModelConfig(model_type=mt, base_filters=16, num_blocks=2),
            generator=torch.Generator().manual_seed(2)).state_dict())
    return out


def _model(mt, sd):
    m = build_model(ModelConfig(model_type=mt, base_filters=16,
                                num_blocks=2))
    m.load_state_dict(sd)
    return m


def _port_loss(mt, sd, b, cfg, mesh_shape=(2, 4), vgg=None, remat=False):
    """The port's sharded loss, comps and gradient (JAX's tree)."""
    m = _model(mt, sd)
    mesh = spatial.make_spatial_mesh(*mesh_shape, [CPU] * 8)
    sl = spatial.build_spatial_loss(mesh, (H, W), cfg, mt, torch.float32,
                                    vgg=vgg, remat=remat)
    total, comps, _ = sl(m.state_dict(keep_vars=True),
                         *(torch.from_numpy(b[k]) for k in ("hr", "lr",
                                                            "weight")))
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(total, list(m.parameters()))
    return (float(total.detach()), {k: float(v) for k, v in comps.items()},
            dict(zip(names, grads)))


def _flat(tree):
    return np.asarray(ravel_pytree(tree)[0])


def _grad_err(port_grads, mt, jax_grads) -> float:
    got = _flat(jax_params_from_state_dict(
        {k: v.detach() for k, v in port_grads.items()}, mt))
    return float(np.abs(got - _flat(jax_grads)).max())


_JAX = {}


def _jax_value_and_grad(mt, cfg_kw, vggp=None):
    """JAX's sharded loss's value_and_grad on its (2, 4) mesh, compiled
    once per family and loss."""
    key = (mt, tuple(sorted(cfg_kw.items())))
    if key not in _JAX:
        cfg = JaxLossConfig(**cfg_kw)
        sl = jax_loss(jax_mesh(2, 4), (H, W), cfg, mt, jnp.float32,
                      vgg_params=vggp)
        _JAX[key] = jax.jit(jax.value_and_grad(
            lambda p, hr, lo, w: sl(p, hr, lo, w)[:2], has_aux=True))
    return _JAX[key]


@pytest.mark.parametrize("model_type", ["unet", "unet_tpu"])
def test_loss_and_grads_match_jax(families, model_type):
    """The sharded loss of the unets on a (2, 4) grid against JAX's
    ``build_spatial_loss`` on its (2, 4) mesh: the loss within rtol 1e-5,
    the gradient within max abs 1e-4 (``tests/test_spatial.py:177-208``);
    every comp key present."""
    params, sd = families[model_type]
    b = _batch()
    loss, comps, grads = _port_loss(model_type, sd, b,
                                    LossConfig(ssim_weight=0.3))
    (jl, jc), jg = _jax_value_and_grad(model_type, {"ssim_weight": 0.3})(
        params, b["hr"], b["lr"], b["weight"])
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    assert sorted(comps) == sorted(spatial._COMP_KEYS)
    for k in spatial._COMP_KEYS:
        np.testing.assert_allclose(comps[k], float(jc[k]), rtol=1e-5,
                                   atol=1e-7)
    assert _grad_err(grads, model_type, jg) < 1e-4


@pytest.mark.parametrize("model_type", ["edsr", "simple"])
def test_trunk_families_match_dense_autograd(families, model_type):
    """edsr and simple: the sharded loss and gradient against the port's
    dense ``CombinedLoss`` through autograd, at the same bars."""
    _, sd = families[model_type]
    b = _batch(seed=1)
    cfg = LossConfig(ssim_weight=0.3)
    loss, _, grads = _port_loss(model_type, sd, b, cfg)
    m = _model(model_type, sd)
    total, _ = CombinedLoss(cfg)(m(torch.from_numpy(b["lr"])),
                                 torch.from_numpy(b["hr"]),
                                 sample_weights=torch.from_numpy(b["weight"]))
    dense = torch.autograd.grad(total, list(m.parameters()))
    np.testing.assert_allclose(loss, float(total), rtol=1e-5)
    err = max(float((g - d).abs().max())
              for g, d in zip(grads.values(), dense))
    assert err < 1e-4, err


@pytest.fixture(scope="module")
def perceptual(families):
    """JAX's random VGG19 weights to ``vgg_layer_idx`` 8 (as numpy and as
    the port's module), the loss config with the perceptual term, a
    batch, and the port's sharded loss, comps and gradient on them."""
    vggp = jax.tree_util.tree_map(np.asarray,
                                  jvgg.random_params(jax.random.key(1), 8))
    kw = {"ssim_weight": 0.3, "perceptual_weight": 0.1, "vgg_layer_idx": 8}
    b = _batch(seed=2)
    vgg = pvgg.VGG19Features.from_params(vggp, 8)
    return vggp, kw, b, vgg, _port_loss("unet", families["unet"][1], b,
                                        LossConfig(**kw), vgg=vgg)


def test_perceptual_term_matches_jax(families, perceptual):
    """The VGG19 stack row-sharded (1-row conv halos, local pools) at
    ``vgg_layer_idx`` 8, JAX's random VGG weights in both: the loss and
    ``perceptual_loss`` within rtol 1e-5, the gradient within 1e-4
    (``tests/test_spatial.py:211-250``)."""
    params, _ = families["unet"]
    vggp, kw, b, _, (loss, comps, grads) = perceptual
    (jl, jc), jg = _jax_value_and_grad("unet", kw, vggp)(
        params, b["hr"], b["lr"], b["weight"])
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    np.testing.assert_allclose(comps["perceptual_loss"],
                               float(jc["perceptual_loss"]), rtol=1e-5)
    assert _grad_err(grads, "unet", jg) < 1e-4


def test_remat_gives_the_same_loss_and_grads(families, perceptual):
    """``remat`` (the forward's blocks and the loss graph recomputed in
    the backward, the perceptual term included) against none: the loss
    within rtol 1e-6, the gradient within rtol 1e-5, atol 1e-6
    (``tests/test_spatial.py:309-334``)."""
    _, kw, b, vgg, (l0, _, g0) = perceptual
    l1, _, g1 = _port_loss("unet", families["unet"][1], b, LossConfig(**kw),
                           vgg=vgg, remat=True)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _case(name, sd, b, mesh=(2, 4), **kw):
    case = {"name": name, "model": {"base_filters": 16}, "state_dict": sd,
            "batch": b, "dtype": "float32", "mesh": mesh,
            "loss": {"ssim_weight": 0.3}, "lr": 1e-4, "weight_decay": 1e-5}
    case.update(kw)
    return case


def _jax_step(params, b, lr, wd, ga=1, mesh_shape=(2, 4), qat_amax=None):
    """JAX's ``build_spatial_train_step`` from ``params``, no
    augmentation."""
    mesh = jax_mesh(*mesh_shape)
    cfg = JaxLossConfig(ssim_weight=0.3)
    opt = jtrain.make_optimizer(wd)
    sl = jax_loss(mesh, b["lr"].shape[1:3], cfg, "unet", jnp.float32,
                  qat_sites=None if qat_amax is None else sorted(qat_amax))
    rsh = replicated_sharding(mesh)
    x4 = NamedSharding(mesh, P("data", "space"))
    dsh = {"hr": x4, "lr": x4, "weight": NamedSharding(mesh, P("data"))}
    step = jax.jit(jtrain.build_spatial_train_step(
        sl, opt, None, grad_accum=ga, qat=qat_amax is not None,
        qat_decay=0.9), in_shardings=(rsh, dsh, None, None),
        out_shardings=(rsh, rsh))
    st = jax.device_put(jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=opt.init(params), qat_amax=qat_amax), rsh)
    st, met = step(st, b, jnp.asarray(lr, jnp.float32), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, st), met


def _step_gates(port, jst, jmet):
    np.testing.assert_allclose(port["metrics"]["loss"], float(jmet["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(port["metrics"]["ssim"], float(jmet["ssim"]),
                               rtol=1e-3, atol=1e-5)
    diff = np.abs(_flat(jax_params_from_state_dict(port["params"]))
                  - _flat(jst.params))
    assert diff.max() <= 2.5e-4, float(diff.max())
    assert np.quantile(diff, 0.99) <= 5e-5


def test_train_step_matches_jax(families):
    """One optimizer step of the port's spatial trainer over the (2, 4)
    grid against JAX's ``build_spatial_train_step`` on its mesh (no
    augmentation: the two packages draw from different generators):
    the bars of ``tests/test_spatial.py:252-307``."""
    params, sd = families["unet"]
    b = _batch(seed=3)
    port = sp_step.run_mesh(_case("plain", sd, b), CPU)
    jst, jmet = _jax_step(params, b, 1e-4, 1e-5)
    _step_gates(port, jst, jmet)
    assert port["adam"]["count"] == int(jst.step) == 1


@pytest.mark.parametrize("model_type", ["unet", "unet_tpu"])
def test_augmented_step_matches_the_dense_step(families, model_type):
    """One step with augmentation on (the same generator draws the same
    flips and rotations for the whole batch) and an EMA, over the (2, 4)
    grid, against the port's dense step on the same batch: the bars of
    ``tests/test_spatial.py:252-307``, the EMA at the params' bars."""
    from mri_superresolution_torch.tools import dp_step
    _, sd = families[model_type]
    b = _batch(seed=3)
    case = _case("aug", sd, b, augment=True, aug_seed=5, ema_decay=0.9,
                 model={"model_type": model_type, "base_filters": 16})
    port = sp_step.run_mesh(case, CPU)
    dense = dp_step.run_case(case, CPU)
    np.testing.assert_allclose(port["metrics"]["loss"],
                               dense["metrics"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(port["metrics"]["ssim"],
                               dense["metrics"]["ssim"], rtol=1e-3, atol=1e-5)
    for what in ("params", "ema"):
        diff = np.concatenate([(port[what][k] - dense[what][k]).abs()
                               .reshape(-1).numpy() for k in dense[what]])
        assert diff.max() <= 2.5e-4, (what, float(diff.max()))
        assert np.quantile(diff, 0.99) <= 5e-5, what


def test_grad_accum_two_matches_one(families):
    """``grad_accum`` 2 against 1 over the (2, 4) grid: loss and SSIM
    within rtol 1e-6, params within 2.5e-4 (0.99-quantile 5e-5), the
    bars of ``tests/test_spatial.py:336-385``."""
    _, sd = families["unet"]
    b = _batch(seed=9)
    one = sp_step.run_mesh(_case("ga1", sd, b), CPU)
    two = sp_step.run_mesh(_case("ga2", sd, b, grad_accum=2), CPU)
    for k in ("loss", "ssim"):
        np.testing.assert_allclose(two["metrics"][k], one["metrics"][k],
                                   rtol=1e-6)
    assert two["metrics"]["ssim_clip_micros"] == 0.0
    diff = np.concatenate([(two["params"][k] - one["params"][k]).abs()
                           .reshape(-1).numpy() for k in one["params"]])
    assert diff.max() <= 2.5e-4 and np.quantile(diff, 0.99) <= 5e-5


@pytest.fixture(scope="module")
def qat_setup(families):
    """``tests/test_qat.py``'s QAT spatial batch, with JAX's unet init of
    key 0 (``families``), and its calibrated ranges."""
    rng = np.random.default_rng(0)
    params = families["unet"][0]
    x = rng.random((4, 32, 32, 1), np.float32)
    hr = rng.random((4, 64, 64, 1), np.float32)
    amax0 = {k: np.asarray(v) for k, v in jqf.calib_amax(
        params, jnp.asarray(x), "unet", jnp.float32).items()}
    return params, {"lr": x, "hr": hr, "weight": np.ones(4, np.float32)}, \
        amax0


def test_qat_step_matches_jax(qat_setup):
    """The QAT spatial step on a (2, 2) grid against JAX's on its (2, 2)
    mesh, at ``tests/test_qat.py:554-613``'s bars: loss and SSIM within
    1e-3, the running ranges within rtol 2e-2, params within 2.2e-3 with
    under 15% of the elements beyond 5e-5 + 2e-3 |p|."""
    params, b, amax0 = qat_setup
    port = sp_step.run_mesh(_case(
        "qat", state_dict_from_jax(params), b, mesh=(2, 2), qat=True,
        qat_amax=amax0, qat_decay=0.9, lr=1e-3, weight_decay=0.0), CPU)
    jst, jmet = _jax_step(params, b, 1e-3, 0.0, mesh_shape=(2, 2),
                          qat_amax={k: jnp.asarray(v)
                                    for k, v in amax0.items()})
    assert abs(port["metrics"]["loss"] - float(jmet["loss"])) < 1e-3
    assert abs(port["metrics"]["ssim"] - float(jmet["ssim"])) < 1e-3
    assert set(port["qat_amax"]) == set(jst.qat_amax)
    for k, v in jst.qat_amax.items():
        np.testing.assert_allclose(port["qat_amax"][k].numpy(), v,
                                   rtol=2e-2, err_msg=k)
    got = _flat(jax_params_from_state_dict(port["params"]))
    want = _flat(jst.params)
    d = np.abs(got - want)
    assert d.max() <= 2.2e-3
    assert (d > 5e-5 + 2e-3 * np.abs(want)).mean() < 0.15


def test_qat_foreground_routing_is_global_per_sample(qat_setup):
    """A batch of pure background: no sample quantizes, the recorded
    statistic is zero and ``qat_any_fg`` false, so the running ranges
    keep their bits (``tests/test_qat.py:615-650``); the loss is
    finite."""
    params, b, amax0 = qat_setup
    bg = {"lr": np.zeros_like(b["lr"]), "hr": np.zeros_like(b["hr"]),
          "weight": np.ones(4, np.float32)}
    port = sp_step.run_mesh(_case(
        "bg", state_dict_from_jax(params), bg, mesh=(2, 2), qat=True,
        qat_amax=amax0, qat_decay=0.9, lr=1e-3, weight_decay=0.0), CPU)
    assert np.isfinite(port["metrics"]["loss"])
    assert port["metrics"]["qat_any_fg"] == 0.0
    for k, v in amax0.items():
        np.testing.assert_array_equal(port["qat_amax"][k].numpy(), v)


def test_spatial_loss_config_validation():
    """Shard-incompatible configs fail when the loss is built, with the
    JAX package's messages (``tests/test_spatial.py:387-412``)."""
    mesh8 = spatial.make_spatial_mesh(1, 8, [CPU] * 8)
    with pytest.raises(ValueError, match="odd"):
        spatial.build_spatial_loss(mesh8, (64, 64), LossConfig(window_size=10))
    with pytest.raises(ValueError, match="halo"):
        spatial.build_spatial_loss(mesh8, (64, 64), LossConfig(window_size=35))
    mesh4 = spatial.make_spatial_mesh(2, 4, [CPU] * 8)
    vgg = pvgg.VGG19Features.from_params(
        pvgg.random_params(torch.Generator().manual_seed(0), 8), 8)
    with pytest.raises(ValueError, match="pools"):
        spatial.build_spatial_loss(
            mesh4, (96, 96), LossConfig(perceptual_weight=0.1,
                                        vgg_layer_idx=36), vgg=vgg)
    with pytest.raises(ValueError, match="must be divisible by 8"):
        spatial.build_spatial_loss(mesh4, (64, 60), LossConfig())


def test_trainer_rejects_bad_spatial_config(tmp_path):
    """The trainer's checks, with JAX's messages
    (``tests/test_spatial.py:414-425``): a shard count that does not
    divide the ranks (one process: one rank) and a family without a
    row-sharded forward."""
    base = dict(full_res_dir=str(tmp_path), low_res_dir=str(tmp_path),
                checkpoint_dir=str(tmp_path / "ckpt"),
                log_dir=str(tmp_path / "logs"))
    with pytest.raises(ValueError, match="must divide"):
        trainer.train(TrainConfig(spatial_shards=3, **base), device="cpu")
    with pytest.raises(ValueError, match="supports model types"):
        trainer.check_spatial(TrainConfig(
            spatial_shards=4, model=ModelConfig(model_type="hourglass"),
            **base), 4)
