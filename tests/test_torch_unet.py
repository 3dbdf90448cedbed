"""The port's unet and its functional ops against the JAX package, on the
CPU: the same params (carried by ``utils.weights.state_dict_from_jax``) and
the same numpy inputs through both."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.models import param_count as jax_param_count
from mri_superresolution_tpu.ops.ssim import ssim as jax_ssim
from mri_superresolution_tpu.utils.torch_compat import flax_to_torch_state_dict
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.models import (UNetSuperRes, build_model,
                                              param_count)
from mri_superresolution_torch.ops import functional as tfn
from mri_superresolution_torch.ops import metrics as tmetrics
from mri_superresolution_torch.ops import resize as tresize
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

# the JAX package's ops/__init__ re-exports functions under some module
# names, so its modules are imported by their full names
jfn = importlib.import_module("mri_superresolution_tpu.ops.functional")
jmetrics = importlib.import_module("mri_superresolution_tpu.ops.metrics")
jresize = importlib.import_module("mri_superresolution_tpu.ops.resize")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxUNet(base_filters=16, initial_alpha=25.0)
    params = init_params(model, jax.random.key(0), (32, 32))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, dtype=torch.float32):
    m = UNetSuperRes(base_filters=16, dtype=dtype)
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    return m.eval()


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


# ------------------------------------------------------------ weights

def test_state_dict_mapping_equals_torch_compat(jax_params):
    """The port's own copy of the mapping gives exactly what the JAX
    package's torch_compat gives, and those are the model's keys."""
    got = state_dict_from_jax(jax_params)
    want = flax_to_torch_state_dict(jax_params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert set(UNetSuperRes(base_filters=16).state_dict()) == set(want)


def test_weights_round_trip_exact(jax_params):
    back = jax_params_from_state_dict(state_dict_from_jax(jax_params))
    want = dict(jax.tree_util.tree_leaves_with_path(jax_params))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, v in got:
        np.testing.assert_array_equal(
            v, np.asarray(want[path], np.float32).reshape(v.shape),
            err_msg=jax.tree_util.keystr(path))


def test_param_count_matches_jax(jax_params):
    assert param_count(UNetSuperRes(base_filters=16)) == \
        jax_param_count(jax_params)


# -------------------------------------------------------------- model

@pytest.mark.parametrize("hw", [(32, 32), (27, 35)])
def test_forward_fp32_matches_jax(jax_params, hw):
    rng = np.random.default_rng(0)
    x = rng.random((2,) + hw + (1,), dtype=np.float32)
    want = np.asarray(JaxUNet(base_filters=16, initial_alpha=25.0).apply(
        {"params": jax_params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(jax_params)(torch.from_numpy(x))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 1)
    assert got.dtype == torch.float32
    # the bar tests/test_unet.py set against the torch reference
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(32, 32), (27, 35)])
def test_forward_bf16_within_metric_budget(jax_params, hw):
    """bf16 rounds at other places in the two frameworks (B1 applies the
    LeakyReLU before its one cast, flax after), so bf16 agreement is held
    to the 0.1 dB budget of tests/test_unet.py against one ground truth."""
    rng = np.random.default_rng(1)
    x = rng.random((2,) + hw + (1,), dtype=np.float32)
    gt = jnp.asarray(rng.random((2, 2 * hw[0], 2 * hw[1], 1),
                                dtype=np.float32))
    want = JaxUNet(base_filters=16, initial_alpha=25.0,
                   dtype=jnp.bfloat16).apply({"params": jax_params},
                                             jnp.asarray(x))
    with torch.no_grad():
        got = _port(jax_params, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = jnp.asarray(got.numpy())
    assert abs(float(jmetrics.psnr(got, gt))
               - float(jmetrics.psnr(want, gt))) <= 0.1
    assert abs(float(jax_ssim(got, gt)) - float(jax_ssim(want, gt))) <= 1e-3


def test_init_is_seeded_kaiming_fan_out():
    g = torch.Generator().manual_seed(0)
    m = build_model(ModelConfig(base_filters=16, initial_alpha=50.0),
                    generator=g)
    m2 = build_model(ModelConfig(base_filters=16, initial_alpha=50.0),
                     generator=torch.Generator().manual_seed(0))
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    assert abs(float(m.alpha.detach()) - 0.5) < 1e-6
    w = m.up1.conv.double_conv[0].weight            # (64, 128, 3, 3)
    want_std = (2.0 / (1 + 0.01 ** 2) / (64 * 9)) ** 0.5
    assert abs(float(w.detach().std()) / want_std - 1) < 0.05
    assert float(m.final_conv[3].bias.detach().abs().sum()) == 0.0
    assert float(m.inc.double_conv[1].weight.detach().sum()) == 16.0


def test_icnr_init_repeats_subbands():
    m = UNetSuperRes(base_filters=16, icnr_init=True,
                     generator=torch.Generator().manual_seed(0))
    w = m.final_up_pixelshuffle.conv.weight          # (32, 16, 3, 3)
    for o in range(0, 32, 4):
        for k in range(1, 4):
            assert torch.equal(w[o], w[o + k])
    assert not torch.equal(w[0], w[4])


def test_build_model_families():
    with pytest.raises(NotImplementedError, match="A8"):
        build_model(ModelConfig(model_type="edsr"))
    with pytest.raises(ValueError):
        build_model(ModelConfig(model_type="nope"))


# ------------------------------------------------------- functional ops

def test_pixel_shuffle_and_max_pool_match_jax():
    rng = np.random.default_rng(2)
    x = rng.random((2, 5, 7, 12), dtype=np.float32)
    np.testing.assert_array_equal(
        tfn.pixel_shuffle(_nchw(x), 2).permute(0, 2, 3, 1).numpy(),
        np.asarray(jfn.pixel_shuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        tfn.max_pool2(_nchw(x)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jfn.max_pool2(jnp.asarray(x))))


def test_group_norm_ref_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 5, 16)).astype(np.float32)
    s = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    got = tfn.group_norm_ref(_nchw(x), torch.from_numpy(s),
                             torch.from_numpy(b))
    want = jfn.group_norm_ref(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32"])
def test_pack_unit_matches_jax(dtype):
    y = np.linspace(-0.2, 1.2, 997).astype(np.float32)
    got = tfn.pack_unit(torch.from_numpy(y), dtype).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfn.pack_unit(
        jnp.asarray(y), dtype)))
    np.testing.assert_array_equal(tfn.pack_unit_np(y, dtype),
                                  jfn.pack_unit_np(y, dtype))
    assert tfn.unit_slope(dtype) == jfn.unit_slope(dtype)


def test_upsample_bilinear_matches_jax_and_torch():
    rng = np.random.default_rng(4)
    x = rng.random((2, 5, 7, 3), dtype=np.float32)
    got = tresize.upsample_bilinear_align_corners(torch.from_numpy(x), 2)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jresize.upsample_bilinear_align_corners(
            jnp.asarray(x), 2)), rtol=1e-6, atol=1e-6)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("method", list(jresize.Interp))
def test_resize_matches_jax(method):
    rng = np.random.default_rng(5)
    img = rng.random((2, 13, 17), dtype=np.float32)
    tm = tresize.Interp(method.value)
    for target in ((26, 34), (7, 9)):
        np.testing.assert_array_equal(
            tresize.resample_matrix(13, target[0], method.value),
            jresize.resample_matrix(13, target[0], method.value))
        got = tresize.resize(torch.from_numpy(img), target, tm).numpy()
        want = np.asarray(jresize.resize(jnp.asarray(img), target, method))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    a = rng.random((1, 9, 11, 1), dtype=np.float32)
    b = rng.random((1, 9, 11, 1), dtype=np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("mse", "rmse", "mae", "psnr"):
        got = float(getattr(tmetrics, name)(ta, tb))
        want = float(getattr(jmetrics, name)(ja, jb))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), name
    assert float(tmetrics.psnr(ta, ta)) == 100.0
    np.testing.assert_array_equal(
        tmetrics.match_histograms_np(a[0, ..., 0], b[0, ..., 0]),
        jmetrics.match_histograms_np(a[0, ..., 0], b[0, ..., 0]))
