"""The port's VGG19 feature extractor and the perceptual term of its
CombinedLoss against the JAX package, on the CPU, fp32. VGG weights are
the JAX package's random draws, carried across as numpy (the port's own
generator cannot draw ``jax.random``'s numbers); images come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu import config as jcfg
from mri_superresolution_tpu.losses import CombinedLoss as JaxLoss
from mri_superresolution_tpu.models import vgg as jvgg
from mri_superresolution_torch import config as tcfg
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import vgg as tvgg
from mri_superresolution_torch.utils.weights import (
    vgg_params_from_state_dict, vgg_state_dict_from_jax)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jvgg.random_params(jax.random.key(0), 35))


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer]), layer
        for leaf in want[layer]:
            np.testing.assert_array_equal(np.asarray(got[layer][leaf]),
                                          np.asarray(want[layer][leaf]),
                                          err_msg=f"{layer}/{leaf}")


def test_layer_table_matches_jax():
    assert tvgg.layer_table() == jvgg.layer_table()
    assert len(tvgg.layer_table()) == 37
    assert tvgg.conv_indices() == jvgg.conv_indices()
    for idx in range(37):
        assert tvgg.n_pools(idx) == jvgg.n_pools(idx), idx


def test_weights_carry_both_ways_exactly(jax_params):
    """JAX tree -> the module's torchvision-layout state_dict -> JAX tree,
    bit for bit; the module's keys are torchvision's."""
    m = tvgg.VGG19Features.from_params(jax_params, 35)
    sd = m.state_dict()
    assert set(sd) == set(vgg_state_dict_from_jax(jax_params))
    assert "features.34.weight" in sd and "features.36.weight" not in sd
    assert not any(p.requires_grad for p in m.parameters())
    _assert_trees_equal(vgg_params_from_state_dict(sd), jax_params)


@pytest.mark.parametrize("idx", [3, 8, 35])
def test_extract_features_match_jax(jax_params, idx):
    """fp32 features within rtol 1e-4 (atol 1e-4 of the largest: ReLU
    outputs near zero)."""
    x = np.random.default_rng(idx).random((2, 32, 32, 1), np.float32)
    want = np.asarray(jvgg.extract_features(jax_params, jnp.asarray(x), idx))
    m = tvgg.VGG19Features.from_params(jax_params, idx)
    with torch.no_grad():
        got = tvgg.extract_features(m, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_npz_cross_reads(tmp_path, jax_params):
    small = {k: jax_params[k] for k in ("conv0", "conv1", "conv2")}
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jvgg.save_params_npz(jpath, small)
    _assert_trees_equal(tvgg.load_params_npz(jpath), small)
    tvgg.save_params_npz(ppath, small)
    _assert_trees_equal(jax.tree_util.tree_map(
        np.asarray, jvgg.load_params_npz(ppath)), small)


@pytest.mark.parametrize("bare", [False, True])
def test_params_from_torch_state_dict_matches_jax(jax_params, bare):
    """A torchvision state_dict (``features.{i}.*`` or bare ``{i}.*``)
    gives the same tree in both packages, cut at the feature index."""
    sd = vgg_state_dict_from_jax(jax_params)
    if bare:
        sd = {k[len("features."):]: v for k, v in sd.items()}
    np_sd = {k: v.numpy() for k, v in sd.items()}
    want = jax.tree_util.tree_map(
        np.asarray, jvgg.params_from_torch_state_dict(np_sd, 8))
    got = tvgg.params_from_torch_state_dict(sd, 8)
    _assert_trees_equal(got, want)
    assert len(got) == 4
    with pytest.raises(KeyError):
        tvgg.params_from_torch_state_dict({}, 8)


def test_random_params_are_seeded_he_normal():
    p = tvgg.random_params(torch.Generator().manual_seed(0), 35)
    q = tvgg.random_params(torch.Generator().manual_seed(0), 35)
    want = jvgg.random_params(jax.random.key(0), 35)
    assert sorted(p) == sorted(want) and len(p) == 16
    _assert_trees_equal(p, q)
    for k, v in want.items():
        assert p[k]["kernel"].shape == v["kernel"].shape, k
        assert not p[k]["bias"].any()
    k = p["conv10"]["kernel"]                     # (3, 3, 512, 512)
    assert abs(k.std() / np.sqrt(2.0 / (512 * 9)) - 1) < 0.02
    assert len(tvgg.random_params(torch.Generator(), 8)) == 4


# --------------------------------------------------------- the perceptual loss

def _pair(seed, b=3, h=32, w=32):
    rng = np.random.default_rng(seed)
    t = rng.random((b, h, w, 1), np.float32)
    o = np.clip(t + 0.1 * rng.standard_normal(t.shape), 0, 1).astype(
        np.float32)
    return o, t


@pytest.mark.parametrize("loss_type", ["l1", "mse"])
@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 2.0]])
def test_perceptual_loss_and_grad_match_jax(jax_params, loss_type, weights):
    """The total, every component and the gradient with respect to the
    output against ``jax.grad`` of the JAX package's CombinedLoss (rtol
    1e-4; the gradient atol 1e-4 of its largest entry, sums of either
    sign through VGG)."""
    o, t = _pair(5)
    w = None if weights is None else np.asarray(weights, np.float32)
    kw = dict(ssim_weight=0.3, perceptual_weight=0.1,
              perceptual_loss_type=loss_type)
    jl = JaxLoss(jcfg.LossConfig(**kw), jax_params)
    (jtot, jcomps), jgrad = jax.value_and_grad(
        lambda a: jl(a, jnp.asarray(t), None if w is None else jnp.asarray(w)),
        has_aux=True)(jnp.asarray(o))
    vgg = tvgg.VGG19Features.from_params(jax_params, 35)
    out = torch.tensor(o, requires_grad=True)
    tot, comps = CombinedLoss(tcfg.LossConfig(**kw), vgg)(
        out, torch.from_numpy(t), None if w is None else torch.from_numpy(w))
    tot.backward()
    assert sorted(comps) == sorted(jcomps)
    assert "perceptual_loss" in comps
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-4)
    for k in comps:
        np.testing.assert_allclose(float(comps[k].detach()),
                                   float(jcomps[k]), rtol=1e-4, err_msg=k)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(out.grad.numpy(), jg, rtol=1e-4,
                               atol=1e-4 * np.abs(jg).max())


def test_perceptual_target_gets_no_gradient(jax_params):
    """The target's features are taken without a gradient (the JAX
    package's stop_gradient): a target that requires grad gets none from
    the perceptual term."""
    o, t = _pair(6, b=2, h=16, w=16)
    vgg = tvgg.VGG19Features.from_params(jax_params, 8)
    cfg = tcfg.LossConfig(ssim_weight=0.0, perceptual_weight=1.0,
                          vgg_layer_idx=8)
    tgt = torch.tensor(t, requires_grad=True)
    out = torch.tensor(o, requires_grad=True)
    tot, comps = CombinedLoss(cfg, vgg)(out, tgt)
    tot.backward()
    assert sorted(comps) == ["perceptual_loss"]
    assert tgt.grad is None and out.grad.abs().sum() > 0


def test_perceptual_loss_needs_vgg_and_a_known_type(jax_params):
    with pytest.raises(ValueError, match="VGG19"):
        CombinedLoss(tcfg.LossConfig(perceptual_weight=0.1))
    vgg = tvgg.VGG19Features.from_params(jax_params, 3)
    loss = CombinedLoss(tcfg.LossConfig(perceptual_weight=0.1,
                                        perceptual_loss_type="huber"), vgg)
    o, t = _pair(7, b=1, h=8, w=8)
    with pytest.raises(ValueError, match="Unsupported perceptual"):
        loss(torch.from_numpy(o), torch.from_numpy(t))
