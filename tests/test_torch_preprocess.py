"""The port's preprocessing ops against the JAX package's on the CPU: the
letterbox, crop and pad of ``ops/resize.py``; ``apply_windowing``,
``clahe`` and ``histogram_equalization`` of ``ops/normalize.py``;
``ops/kspace.simulate_low_field_mri`` at noise 0 and with JAX's draws
carried across; and ``ops/pipeline.preprocess_slice`` over its options.
Inputs are drawn with numpy from a seed; each tolerance is stated where it
is checked."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.ops import kspace as jk
from mri_superresolution_tpu.ops import normalize as jn
from mri_superresolution_tpu.ops import pipeline as jp
from mri_superresolution_torch.ops import kspace as tk
from mri_superresolution_torch.ops import normalize as tn
from mri_superresolution_torch.ops import pipeline as tp

# the packages' ops/__init__ export a function named resize
jr = importlib.import_module("mri_superresolution_tpu.ops.resize")
tr = importlib.import_module("mri_superresolution_torch.ops.resize")

torch.set_num_threads(2)

# non-square clinical matrices, odd sizes, up- and downscales
LETTERBOX_CASES = [((90, 70), (64, 64)), ((192, 256), (256, 256)),
                   ((192, 256), (128, 128)), ((61, 77), (50, 40)),
                   ((40, 33), (100, 90))]
CROP_PAD_CASES = [((90, 70), (64, 64)), ((61, 77), (50, 90)),
                  ((40, 33), (100, 20)), ((64, 64), (64, 64))]


def _jax_draws(key, shape):
    """The two normal draws ``jk.simulate_low_field_mri`` makes from
    ``key`` (ops/kspace.py:69-71 of the JAX package), as numpy."""
    kr, ki = jax.random.split(key)
    return (np.array(jax.random.normal(kr, shape, jnp.float32)),
            np.array(jax.random.normal(ki, shape, jnp.float32)))


def _codes(x01: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(x01) * 255.0).astype(np.int64)


@pytest.mark.parametrize("in_hw,target", LETTERBOX_CASES)
def test_letterbox_geometry_matches_jax(in_hw, target):
    assert tr.letterbox_geometry(in_hw, target) == \
        jr.letterbox_geometry(in_hw, target)


@pytest.mark.parametrize("method", ["LANCZOS", "AREA", "CUBIC", "LINEAR",
                                    "NEAREST"])
@pytest.mark.parametrize("in_hw,target", LETTERBOX_CASES)
def test_letterbox_resize_matches_jax(in_hw, target, method):
    """The canvas, placement and padding exactly; the resampled values
    within 1e-6 on [0, 1] inputs (the fp32 products sum in another order
    than XLA's dot)."""
    x = np.random.default_rng(0).random((3, *in_hw)).astype(np.float32)
    want = np.asarray(jr.letterbox_resize(jnp.asarray(x), target,
                                          jr.Interp[method], 0.25))
    got = tr.letterbox_resize(torch.from_numpy(x), target,
                              tr.Interp[method], 0.25).numpy()
    assert got.shape == want.shape == (3, target[1], target[0])
    np.testing.assert_array_equal(got == 0.25, want == 0.25)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    two_d = tr.letterbox_resize(torch.from_numpy(x[0]), target,
                                tr.Interp[method], 0.25).numpy()
    np.testing.assert_array_equal(two_d, got[0])


@pytest.mark.parametrize("in_hw,target", CROP_PAD_CASES)
@pytest.mark.parametrize("name", ["center_crop", "pad_to_size"])
def test_crop_and_pad_match_jax_exactly(in_hw, target, name):
    x = np.random.default_rng(1).random((2, *in_hw)).astype(np.float32)
    want = np.asarray(getattr(jr, name)(jnp.asarray(x), target))
    got = getattr(tr, name)(torch.from_numpy(x), target).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("center,width,out_range", [
    (400.0, 300.0, (0.0, 1.0)), (0.5, 0.25, (-1.0, 1.0)),
    (100.0, 0.0, (0.0, 1.0))])
def test_apply_windowing_matches_jax(center, width, out_range):
    x = (np.random.default_rng(2).random((2, 30, 20)) * 900 - 100).astype(
        np.float32)
    want = np.asarray(jax.vmap(lambda s: jn.apply_windowing(
        s, center, width, out_range))(jnp.asarray(x)))
    got = tn.apply_windowing(torch.from_numpy(x), center, width,
                             out_range).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _equalize_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((3, *shape)) ** 2).astype(np.float32)
    x[1] = 0.4                                   # a constant slice
    x[2, :5] = rng.random((5, shape[1])) * 1.5 - 0.2   # outside [0, 1]
    return x


@pytest.mark.parametrize("shape,clip,grid", [
    ((64, 64), 2.0, (8, 8)), ((90, 70), 2.0, (8, 8)), ((61, 77), 4.0, (4, 6)),
    ((17, 9), 2.0, (8, 8)), ((90, 70), 0.5, (3, 2)), ((61, 77), 2.0, (8, 8))])
def test_clahe_codes_match_jax(shape, clip, grid):
    """Identical uint8 codes, slice by slice against JAX's per-slice clahe,
    for a batch and for one (h, w) slice."""
    x = _equalize_inputs(shape, 3)
    want = np.stack([np.asarray(jn.clahe(jnp.asarray(s), clip, grid))
                     for s in x])
    got = tn.clahe(torch.from_numpy(x), clip, grid).numpy()
    np.testing.assert_array_equal(_codes(got), _codes(want))
    one = tn.clahe(torch.from_numpy(x[0]), clip, grid).numpy()
    np.testing.assert_array_equal(_codes(one), _codes(want[0]))


@pytest.mark.parametrize("shape", [(64, 64), (90, 70), (5, 3)])
def test_histogram_equalization_codes_match_jax(shape):
    x = _equalize_inputs(shape, 4)
    want = np.stack([np.asarray(jn.histogram_equalization(jnp.asarray(s)))
                     for s in x])
    got = tn.histogram_equalization(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_codes(got), _codes(want))
    np.testing.assert_array_equal(
        tn.histogram_equalization(torch.from_numpy(x[2])).numpy(), got[2])


@pytest.mark.parametrize("shape,crop", [((3, 48, 40), 0.5), ((2, 61, 77), 0.3),
                                        ((1, 64, 64), 1.0)])
@pytest.mark.parametrize("noise_std", [0.0, 5.0, 20.0])
def test_kspace_sim_matches_jax(shape, crop, noise_std):
    """At noise 0 (no draws passed), and with JAX's draws carried across
    as numpy: rtol 1e-5, atol 1e-5 on [0, 1] slices."""
    x = np.random.default_rng(5).random(shape).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jk.simulate_low_field_mri(jnp.asarray(x), key, crop,
                                                noise_std))
    noise = None if noise_std == 0 else tuple(
        torch.from_numpy(d) for d in _jax_draws(key, shape))
    got = tk.simulate_low_field_mri(torch.from_numpy(x), noise, crop,
                                    noise_std).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    one = tk.simulate_low_field_mri(torch.from_numpy(x[0]), None if noise
                                    is None else tuple(n[:1] for n in noise),
                                    crop, noise_std).numpy()
    np.testing.assert_allclose(one, got[0], rtol=1e-6, atol=1e-6)


def test_kspace_sim_noise_statistics():
    """Rician magnitude noise (tests/test_ops.py's case, with the port's
    own draws): with the whole k-space kept and noise added, the output
    differs from the input, keeps each slice's range, and differs from
    slice to slice; one generator seed gives the same draws twice."""
    x = np.tile(np.linspace(0, 1, 64, dtype=np.float32), (64, 1))
    batch = torch.from_numpy(np.stack([x] * 4))
    draws = tk.draw_kspace_noise((4, 64, 64),
                                 torch.Generator().manual_seed(1))
    again = tk.draw_kspace_noise((4, 64, 64),
                                 torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    assert all(d.dtype == torch.float32 for d in draws)
    out = tk.simulate_low_field_mri(batch, draws, 1.0, 10.0).numpy()
    assert out.shape == (4, 64, 64)
    for i in range(4):
        assert abs(out[i].min() - x.min()) < 1e-5
        assert abs(out[i].max() - x.max()) < 1e-5
        assert np.abs(out[i] - x).mean() > 1e-4
    assert np.abs(out[0] - out[1]).mean() > 1e-5


def test_kspace_crop_removes_high_frequencies():
    x = np.zeros((64, 64), np.float32)
    x[::2] = 1.0
    out = tk.simulate_low_field_mri(torch.from_numpy(x), None, 0.25,
                                    0.0).numpy()
    assert np.abs(np.diff(out, axis=0)).mean() < \
        0.5 * np.abs(np.diff(x, axis=0)).mean()


@pytest.mark.parametrize("method", ["LETTERBOX", "CROP", "PAD", "STRETCH"])
@pytest.mark.parametrize("equalize", [False, True])
@pytest.mark.parametrize("simulate", [False, True])
@pytest.mark.parametrize("window", [None, (400.0, 500.0)])
def test_preprocess_slice_matches_jax(method, equalize, simulate, window):
    """Every resize method, CLAHE on and off, the simulation on (JAX's
    draws carried across) and off, percentile and manual windows, on a
    non-square slice: atol 1e-6, one fp32 ulp of a single slice's
    percentile (the port rounds it as a single slice's
    ``jnp.percentile`` does)."""
    x = (np.random.default_rng(6).random((90, 70)) * 900).astype(np.float32)
    key = jax.random.key(0)
    kw = {} if window is None else dict(window_center=window[0],
                                        window_width=window[1])
    want = np.asarray(jp.preprocess_slice(
        jnp.asarray(x), (64, 48), jr.Interp.CUBIC, equalize,
        resize_method=jp.ResizeMethod[method], apply_simulation=simulate,
        rng_key=key, **kw))
    noise = tuple(torch.from_numpy(d) for d in _jax_draws(key, (1, 90, 70)))
    got = tp.preprocess_slice(
        torch.from_numpy(x), (64, 48), tr.Interp.CUBIC, equalize,
        resize_method=tp.ResizeMethod[method], apply_simulation=simulate,
        noise=noise, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("interp", ["LANCZOS", "AREA", "LINEAR"])
def test_preprocess_slice_without_target_and_other_interp(interp):
    """No ``target_size`` leaves the size; other interpolations letterbox
    as JAX's (atol 1e-6)."""
    x = (np.random.default_rng(7).random((61, 77)) * 300).astype(np.float32)
    same = tp.preprocess_slice(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(same, np.asarray(jp.preprocess_slice(
        jnp.asarray(x))), rtol=0, atol=1e-6)
    want = np.asarray(jp.preprocess_slice(jnp.asarray(x), (50, 50),
                                          jr.Interp[interp]))
    got = tp.preprocess_slice(torch.from_numpy(x), (50, 50),
                              tr.Interp[interp]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
