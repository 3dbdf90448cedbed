"""The port's training pieces against the JAX package, on the CPU: B1's
plain backward, the combined loss, the augmentation, the data loaders, the
schedulers and the configs. The same numpy inputs go through both."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu import config as jcfg
from mri_superresolution_tpu.data import dataset as jdata
from mri_superresolution_tpu.experiments.groupnorm_pallas import (
    _backward as jax_gn_backward)
from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
from mri_superresolution_tpu.train import plateau as jplateau
from mri_superresolution_torch import config as tcfg
from mri_superresolution_torch.data import dataset as tdata
from mri_superresolution_torch.kernels.groupnorm import (
    group_norm_leaky, group_norm_leaky_backward,
    group_norm_leaky_backward_plain, group_norm_leaky_plain)
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models.vgg import VGG19Features, random_params
from mri_superresolution_torch.ops import augment as taug
from mri_superresolution_torch.train import plateau as tplateau

# the JAX package's ops/__init__ re-exports functions under module names
jaug = importlib.import_module("mri_superresolution_tpu.ops.augment")

torch.set_num_threads(2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _gn_inputs(shape, seed):
    """NHWC x and g, (C,) scale and bias, as numpy fp32."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    return (rng.standard_normal(shape).astype(np.float32) * 2 + 0.5,
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(c).astype(np.float32),
            rng.standard_normal(c).astype(np.float32))


# ------------------------------------------------------------ B1 backward

@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 11, 24),
                                   (3, 4, 4, 64)])
def test_b1_plain_backward_matches_jax(shape):
    """The plain twin against the JAX package's analytic ``_backward``
    (fp32, rtol 1e-5)."""
    x, g, s, b = _gn_inputs(shape, 0)
    want = jax_gn_backward(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                           8, 0.2, 1e-5, jnp.asarray(g))
    dx, ds, db = group_norm_leaky_backward_plain(
        _nchw(x), torch.from_numpy(s), torch.from_numpy(b), _nchw(g))
    assert dx.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("with_res", [False, True])
def test_b1_function_grads_match_autograd_of_plain(with_res):
    """group_norm_leaky as an autograd.Function on the CPU (forward plain,
    backward the plain twin) against torch autograd of
    group_norm_leaky_plain: every input's gradient, the residual's
    included, within rtol 1e-5."""
    x, g, s, b = _gn_inputs((2, 6, 7, 16), 1)
    res = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)
    grads = []
    for fn in (group_norm_leaky, group_norm_leaky_plain):
        ins = [_nchw(x).requires_grad_(), torch.tensor(s, requires_grad=True),
               torch.tensor(b, requires_grad=True)]
        r = _nchw(res).requires_grad_() if with_res else None
        y = fn(*ins, residual=r)
        y.backward(_nchw(g))
        grads.append([t.grad for t in ins + ([r] if with_res else [])])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_b1_backward_wrapper_on_cpu_is_the_twin():
    x, g, s, b = _gn_inputs((2, 4, 4, 16), 3)
    args = (_nchw(x), torch.from_numpy(s), torch.from_numpy(b), _nchw(g))
    for got, want in zip(group_norm_leaky_backward(*args),
                         group_norm_leaky_backward_plain(*args)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="channels_last"):
        group_norm_leaky_backward(*args[:3], _nchw(g).contiguous())


# -------------------------------------------------------------- the loss

def _pair(seed, b=3, h=24, w=20):
    rng = np.random.default_rng(seed)
    t = rng.random((b, h, w, 1), np.float32)
    o = np.clip(t + 0.1 * rng.standard_normal(t.shape), 0, 1).astype(
        np.float32)
    return o, t


@pytest.mark.parametrize("ssim_weight", [0.3, 0.0, 1.0])
@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 2.0]])
def test_combined_loss_matches_jax(ssim_weight, weights):
    """Loss, components and the gradient with respect to the output
    against the JAX package's CombinedLoss (rtol 1e-5)."""
    o, t = _pair(4)
    w = None if weights is None else np.asarray(weights, np.float32)
    jl = JaxLoss(jcfg.LossConfig(ssim_weight=ssim_weight))
    (jtot, jcomps), jgrad = jax.value_and_grad(
        lambda a: jl(a, jnp.asarray(t), None if w is None else jnp.asarray(w)),
        has_aux=True)(jnp.asarray(o))
    out = torch.tensor(o, requires_grad=True)
    tot, comps = CombinedLoss(tcfg.LossConfig(ssim_weight=ssim_weight))(
        out, torch.from_numpy(t), None if w is None else torch.from_numpy(w))
    tot.backward()
    assert sorted(comps) == sorted(jcomps)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for k in comps:
        np.testing.assert_allclose(float(comps[k].detach()),
                                   float(jcomps[k]), rtol=1e-5)
    # the SSIM gradient is a sum over the window of terms of either sign:
    # atol 1e-5 of the largest entry
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(out.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def test_combined_loss_metric_only_and_refusals():
    """With ssim_weight 0 the loss has no SSIM term, and the trainer's
    metric is JAX's ``ssim(..., sample_weights=w)``."""
    from mri_superresolution_torch.train.trainer import _ssim_metric
    o, t = _pair(5)
    w = np.array([1.0, 0.0, 2.0], np.float32)
    loss = CombinedLoss(tcfg.LossConfig(ssim_weight=0.0))
    _, comps = loss(torch.from_numpy(o), torch.from_numpy(t))
    assert sorted(comps) == ["l1_loss"]
    jssim = importlib.import_module("mri_superresolution_tpu.ops.ssim")
    np.testing.assert_allclose(
        float(_ssim_metric(loss, torch.from_numpy(o), torch.from_numpy(t),
                           torch.from_numpy(w))),
        float(jssim.ssim(jnp.asarray(o), jnp.asarray(t),
                         sample_weights=jnp.asarray(w))), rtol=1e-5)
    # the perceptual term needs VGG19 weights, as JAX's CombinedLoss does
    with pytest.raises(ValueError, match="VGG19"):
        CombinedLoss(tcfg.LossConfig(perceptual_weight=0.1))
    vgg = VGG19Features.from_params(
        random_params(torch.Generator().manual_seed(0), 3), 3)
    _, comps = CombinedLoss(tcfg.LossConfig(perceptual_weight=0.1,
                                            vgg_layer_idx=3), vgg)(
        torch.from_numpy(o), torch.from_numpy(t))
    assert sorted(comps) == ["l1_loss", "perceptual_loss", "ssim_loss",
                             "ssim_metric"]
    assert float(comps["perceptual_loss"]) > 0
    with pytest.raises(ValueError, match="exceed"):
        CombinedLoss(tcfg.LossConfig(ssim_weight=0.9, perceptual_weight=0.5))


# --------------------------------------------------------- augmentation

ANGLES = np.array([-4.7, 2.3, 5.9], np.float32)
FILLS = np.array([0.1, 0.5, 0.9], np.float32)


@pytest.mark.parametrize("method", ["nearest", "linear"])
def test_rotate_shear_matches_jax(method):
    img = np.random.default_rng(6).random((3, 30, 22, 1), np.float32)
    want = jax.vmap(lambda i, a, f: jaug.rotate_shear(i, a, f, method, 6.0))(
        img, ANGLES, FILLS)
    got = taug.rotate_shear(torch.from_numpy(img), torch.from_numpy(ANGLES),
                            torch.from_numpy(FILLS), method, 6.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_rotate_nearest_matches_jax():
    img = np.random.default_rng(7).random((3, 17, 26, 1), np.float32)
    want = jax.vmap(lambda i, a, f: jaug.rotate(i, a, f, "nearest"))(
        img, ANGLES, FILLS)
    got = taug.rotate(torch.from_numpy(img), torch.from_numpy(ANGLES),
                      torch.from_numpy(FILLS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


ALL_ON = dict(enabled=True, flip_prob=0.5, rotate_prob=0.5,
              brightness_prob=0.5, contrast_prob=0.5, noise_prob=0.5)


def _jax_draws(key, b, lr_shape, cfg):
    """The draws ``ops/augment.augment_pair`` of the JAX package makes from
    ``key``, in its order, named as ``draw_augment`` names them."""
    keys = jax.random.split(key, 6)
    k1, k2 = jax.random.split(keys[5])
    d = {"u_flip": jax.random.uniform(keys[0], (b,)),
         "u_rot": jax.random.uniform(keys[1], (b,)),
         "angle": jax.random.uniform(keys[2], (b,),
                                     minval=cfg.rotate_range[0],
                                     maxval=cfg.rotate_range[1]),
         "u_bri": jax.random.uniform(keys[3], (b, 2)),
         "u_con": jax.random.uniform(keys[4], (b, 2)),
         "u_noise": jax.random.uniform(k1, (b,)),
         "noise": jax.random.normal(k2, lr_shape)}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("seed", [3, 11])
def test_augment_pair_matches_jax_on_its_draws(seed):
    rng = np.random.default_rng(seed)
    hr = rng.random((4, 32, 32, 1), np.float32)
    lr = rng.random((4, 16, 16, 1), np.float32)
    jc = jcfg.AugmentConfig(**ALL_ON)
    key = jax.random.key(seed)
    wh, wl = jaug.augment_pair(jnp.asarray(hr), jnp.asarray(lr), key, jc)
    gh, gl = taug.apply_augment(torch.from_numpy(hr), torch.from_numpy(lr),
                                _jax_draws(key, 4, lr.shape, jc),
                                tcfg.AugmentConfig(**ALL_ON))
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-6)


def test_augment_pair_properties():
    """HR and LR take the same flip and rotation decisions, values stay in
    [0, 1], the noise goes on LR only, and one generator seed gives one
    output."""
    rng = np.random.default_rng(8)
    hr = torch.from_numpy(rng.random((6, 32, 32, 1), np.float32))
    lr = torch.nn.functional.avg_pool2d(hr.permute(0, 3, 1, 2), 2).permute(
        0, 2, 3, 1).contiguous()
    cfg = tcfg.AugmentConfig(**ALL_ON)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    h1, l1 = taug.augment_pair(hr, lr, gen(), cfg)
    h2, l2 = taug.augment_pair(hr, lr, gen(), cfg)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    for t in (h1, l1):
        assert float(t.min()) >= 0.0 and float(t.max()) <= 1.0
    d = taug.draw_augment(6, lr.shape, cfg, gen())
    flip = d["u_flip"] < cfg.flip_prob
    assert 0 < int(flip.sum()) < 6
    # geometry only: HR flipped exactly where LR is (LR is HR pooled, so a
    # flip shows in both or in neither)
    geo = tcfg.AugmentConfig(enabled=True, flip_prob=0.5, rotate_prob=0.0,
                             brightness_prob=0.0, contrast_prob=0.0,
                             noise_prob=0.0)
    gh, gl = taug.apply_augment(hr, lr, d, geo)
    for i in range(6):
        assert torch.equal(gh[i], hr[i].flip(1) if flip[i] else hr[i])
        assert torch.equal(gl[i], lr[i].flip(1) if flip[i] else lr[i])
    # rotation: the same angle on both, so LR still matches pooled HR
    rot = dataclasses.replace(geo, flip_prob=0.0, rotate_prob=1.0)
    gh, gl = taug.apply_augment(hr, lr, d, rot)
    assert not torch.equal(gh, hr)
    pooled = torch.nn.functional.avg_pool2d(gh.permute(0, 3, 1, 2), 2)
    assert float((pooled.permute(0, 2, 3, 1) - gl).abs().mean()) < 0.05
    # noise: LR only
    noise = dataclasses.replace(geo, flip_prob=0.0, noise_prob=1.0)
    gh, gl = taug.apply_augment(hr, lr, d, noise)
    assert torch.equal(gh, hr) and not torch.equal(gl, lr)


# --------------------------------------------------- loaders and splits

def test_splits_match_jax():
    subjects = [f"s{i % 5}" for i in range(23)]
    for a, b in zip(tdata.train_val_split(23, 0.2, 7),
                    jdata.train_val_split(23, 0.2, 7)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdata.subject_split(subjects, 0.3, 7),
                    jdata.subject_split(subjects, 0.3, 7)):
        np.testing.assert_array_equal(a, b)


def test_loaders_give_jax_index_batches():
    """For the same seed both loaders yield the JAX package's batches: the
    (seed, epoch) shuffle, the padding rows and their zero weights."""
    n = 11
    lr = np.arange(n, dtype=np.uint8).reshape(n, 1, 1) * np.ones(
        (1, 2, 2), np.uint8)
    hr = np.arange(n, dtype=np.uint8).reshape(n, 1, 1) * np.ones(
        (1, 4, 4), np.uint8)
    idx = np.array([3, 0, 7, 9, 1, 4, 10])
    for shuffle in (True, False):
        for epoch in (0, 3, None):
            t = tdata.BatchLoader(lr, hr, idx, 3, shuffle, seed=5)
            j = jdata.BatchLoader(lr, hr, idx, 3, shuffle, seed=5)
            tb, jb = list(t.epoch(epoch)), list(j.epoch(epoch))
            assert len(tb) == len(jb) == len(t) == 3
            for a, b in zip(tb, jb):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])


def test_streaming_loader_matches_in_memory(tmp_path):
    from mri_superresolution_torch import native
    n = 7
    (tmp_path / "hr").mkdir()
    (tmp_path / "lr").mkdir()
    for i in range(n):
        native.imwrite_gray(str(tmp_path / "hr" / f"sub-{i}_s.png"),
                            np.full((8, 6), 30 * i, np.uint8))
        native.imwrite_gray(str(tmp_path / "lr" / f"sub-{i}_s.png"),
                            np.full((4, 3), 30 * i + 1, np.uint8))
    ds = tdata.PairedSliceDataset(str(tmp_path / "hr"), str(tmp_path / "lr"))
    assert len(ds) == n and ds.item_hw() == ((4, 3), (8, 6))
    lr, hr = ds.load_all()
    idx = np.arange(n)
    mem = list(tdata.BatchLoader(lr, hr, idx, 3, True, seed=2).epoch(1))
    stream = tdata.StreamingBatchLoader(ds, idx, 3, True, seed=2,
                                        prefetch=1)
    for a, b in zip(mem, stream.epoch(1)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert stream.decode_batch_calls == 3


# ------------------------------------------------ schedulers and configs

def test_plateau_and_early_stop_match_jax():
    vals = [1.0, 0.9, 0.95, 0.91, 0.92, 0.93, 0.89, 0.9, 0.9, 0.9, 0.9]
    t, j = tplateau.ReduceLROnPlateau(1e-3, patience=2), \
        jplateau.ReduceLROnPlateau(1e-3, patience=2)
    te, je = tplateau.EarlyStopping(3), jplateau.EarlyStopping(3)
    for v in vals:
        assert t.step(v) == j.step(v)
        assert te.update(v) == je.update(v)
        assert te.should_stop == je.should_stop
    assert t.state_dict() == j.state_dict()
    assert te.state_dict() == je.state_dict()


def test_train_config_reads_the_same_in_both_packages():
    """A checkpoint sidecar's ``config`` block is the same dict whichever
    package wrote it, and each package reads the other's."""
    t = tcfg.TrainConfig(full_res_dir="h", low_res_dir="l", batch_size=4,
                         model=tcfg.ModelConfig(base_filters=16),
                         augment=tcfg.AugmentConfig(enabled=True),
                         grad_accum=2, ema_decay=0.99)
    j = jcfg.TrainConfig(full_res_dir="h", low_res_dir="l", batch_size=4,
                         model=jcfg.ModelConfig(base_filters=16),
                         augment=jcfg.AugmentConfig(enabled=True),
                         grad_accum=2, ema_decay=0.99)
    assert tcfg.to_dict(t) == jcfg.to_dict(j)
    assert tcfg.train_config_from_dict(jcfg.to_dict(j)) == t
    assert jcfg.train_config_from_dict(tcfg.to_dict(t)) == j
