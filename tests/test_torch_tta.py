"""The port's dihedral TTA (``ops/tta.py`` and the engine's ``tta``)
against the JAX package's, on the CPU (``device="cpu"``, fp32), with the
same params in both; case for case with the JAX package's own TTA tests
(tests/test_infer.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.infer import InferenceEngine as JaxEngine
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.ops.tta import dihedral_pairs as jax_pairs
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer import InferenceEngine
from mri_superresolution_torch.ops.tta import dihedral_pairs, tta_ensemble
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

CFG = ModelConfig(base_filters=16)


@pytest.fixture(scope="module")
def jax_params():
    params = init_params(JaxUNet(base_filters=16), jax.random.key(0),
                         (16, 16))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, **kw):
    return InferenceEngine(CFG, state_dict_from_jax(params), bf16=False,
                           device="cpu", **kw)


def _jax(params, **kw):
    return JaxEngine(JaxModelConfig(base_filters=16), params, bf16=False,
                     num_devices=1, **kw)


@pytest.mark.parametrize("shape", [(2, 6, 6), (3, 5, 7)])
def test_dihedral_pairs_match_jax(shape):
    """The same members in the same order, identity first, on numpy
    arrays and on tensors; every inverse undoes its transform."""
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    square = shape[1] == shape[2]
    got, want = dihedral_pairs(square), jax_pairs(square)
    assert len(got) == len(want) == (8 if square else 4)
    for (t, inv), (jt, _) in zip(got, want):
        np.testing.assert_array_equal(t(x), np.asarray(jt(x)))
        np.testing.assert_array_equal(
            t(torch.from_numpy(x)).numpy(), np.asarray(jt(x)))
        np.testing.assert_array_equal(inv(t(x)), x)
        np.testing.assert_array_equal(
            inv(t(torch.from_numpy(x))).numpy(), x)
    np.testing.assert_array_equal(got[0][0](x), x)


@pytest.mark.parametrize("shape,bucket", [
    ((2, 16, 16), 1), ((2, 16, 24), 1), ((2, 10, 10), 32), ((3, 10, 14), 32)])
def test_tta_matches_jax(jax_params, shape, bucket):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    got = _port(jax_params, tta=True, bucket=bucket).upscale_batch(x)
    want = _jax(jax_params, tta=True, bucket=bucket).upscale_batch(x)
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2])
    # the padded members carry the engine's bucket tolerance
    # (tests/test_torch_engine.py: E[x^2] - mean^2 over the zero pad)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 if bucket == 1 else 1e-4)


@pytest.mark.parametrize("shape,bucket", [((2, 16, 16), 1),
                                          ((2, 16, 24), 1),
                                          ((2, 10, 10), 32),
                                          ((3, 10, 14), 32)])
def test_tta_is_the_dihedral_mean_of_the_plain_engine(jax_params, shape,
                                                      bucket):
    """The card-resident ensemble equals a hand-run loop over the plain
    engine with the same bucket (transform, then pad; crop, then invert),
    and is dihedral-equivariant by construction."""
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    eng_tta = _port(jax_params, tta=True, bucket=bucket)
    plain = _port(jax_params, bucket=bucket)
    pairs = dihedral_pairs(square=(shape[1] == shape[2]))
    acc = np.zeros((shape[0], 2 * shape[1], 2 * shape[2]), np.float32)
    for t, inv in pairs:
        acc += inv(plain.upscale_batch(np.ascontiguousarray(t(x))))
    y = eng_tta.upscale_batch(x)
    np.testing.assert_allclose(y, acc / len(pairs), rtol=1e-5, atol=1e-6)
    flipped = eng_tta.upscale_batch(np.ascontiguousarray(x[:, ::-1]))
    np.testing.assert_allclose(flipped[:, ::-1], y, rtol=1e-5, atol=1e-6)


def test_tta_ensemble_pads_after_the_transform():
    """``tta_ensemble`` calls the forward once a member, one member at a
    time, with each member padded after its transform and the output
    cropped before the inverse."""
    seen = []

    def forward(a):
        seen.append(tuple(a.shape))
        return torch.nn.functional.interpolate(
            a.permute(0, 3, 1, 2), scale_factor=2).permute(0, 2, 3, 1)

    x = torch.rand(2, 6, 6, 1)
    y = tta_ensemble(forward, x, lambda h, w: (8, 8))
    assert seen == [(2, 8, 8, 1)] * 8
    want = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), scale_factor=2).permute(0, 2, 3, 1)
    torch.testing.assert_close(y, want)


def _frozen_scales(jax_params, rng, tmp_path):
    calib = rng.random((4, 16, 16, 1), dtype=np.float32)
    scales = jqf.calibrate(jax_params, [calib], "unet", dtype=jnp.float32)
    path = str(tmp_path / "scales.json")
    jqf.save_scales(path, scales, "unet")
    return path


def test_tta_int8_frozen_on_card(jax_params, tmp_path):
    """With frozen scales the ensemble wraps the int8 forward (one routing
    decision and one count a batch); it equals the loop over the frozen
    int8 forward, and JAX's int8 ensemble with the same scales. A near-
    empty batch takes the bf16 ensemble."""
    rng = np.random.default_rng(3)
    path = _frozen_scales(jax_params, rng, tmp_path)
    kw = dict(quant="int8", quant_calib_path=path, quant_min_foreground=0.05,
              tta=True)
    eng, jeng = _port(jax_params, **kw), _jax(jax_params, **kw)
    x = rng.random((2, 16, 16), dtype=np.float32)
    assert eng._tta_on_device()
    y = eng.upscale_batch(x)
    assert eng._quant_batches == {"int8": 1, "bf16": 0}
    acc = np.zeros((2, 32, 32), np.float32)
    with torch.inference_mode():
        for t, inv in dihedral_pairs(square=True):
            out = eng._quant_fwd(eng._params, torch.from_numpy(
                np.ascontiguousarray(t(x))[..., None])).clamp(0, 1)
            acc += inv(out[..., 0].numpy())
    np.testing.assert_allclose(y, acc / 8, rtol=1e-5, atol=1e-6)
    want = jeng.upscale_batch(x)
    assert jeng._quant_batches == eng._quant_batches
    # the two packages' int8 forwards are not equal to 1e-5 (one forward:
    # mean 5e-3 apart, tests/test_torch_quant.py holds them to the bf16
    # budget): the ensembles are held to that budget against the fp32
    # TTA, and to a fifth of int8's own distance from it
    ref = _port(jax_params, tta=True).upscale_batch(x)

    def db(a):
        return 10 * np.log10(1.0 / np.mean((a - ref) ** 2))

    assert abs(db(y) - db(want)) <= 0.1
    assert np.abs(y - want).mean() <= 0.2 * np.abs(want - ref).mean()

    bg = np.zeros((2, 16, 16), np.float32)
    np.testing.assert_allclose(eng.upscale_batch(bg), jeng.upscale_batch(bg),
                               rtol=1e-5, atol=1e-5)
    assert eng._quant_batches == jeng._quant_batches == {"int8": 1,
                                                         "bf16": 1}


def test_tta_int8_calibration_counts_slices_once(jax_params):
    """While int8 calibrates, the host loop runs: only the identity pass
    feeds calibration, and all 8 members are served bf16, which makes the
    output the plain TTA's."""
    kw = dict(quant="int8", quant_calib_slices=100, quant_min_foreground=0.0,
              tta=True)
    eng, jeng = _port(jax_params, **kw), _jax(jax_params, **kw)
    x = np.random.default_rng(4).random((2, 16, 16), dtype=np.float32)
    assert not eng._tta_on_device()
    y = eng.upscale_batch(x)
    np.testing.assert_allclose(y, jeng.upscale_batch(x), rtol=1e-5,
                               atol=1e-5)
    assert eng._calib_seen == jeng._calib_seen == 2
    assert eng._quant_fwd is None
    np.testing.assert_allclose(
        y, _port(jax_params, tta=True).upscale_batch(x), rtol=1e-6,
        atol=1e-7)


def test_tta_int8_freeze_mid_ensemble_stays_bf16(jax_params):
    """A TTA batch whose identity pass completes calibration freezes the
    scales but stays bf16 for all its members; the next batch runs the
    int8 ensemble on the card; one ensemble counts as one batch."""
    kw = dict(quant="int8", quant_calib_slices=3, quant_min_foreground=0.0,
              tta=True)
    eng, jeng = _port(jax_params, **kw), _jax(jax_params, **kw)
    plain = _port(jax_params, tta=True)
    rng = np.random.default_rng(5)
    x1, x2, x3 = (rng.random((2, 16, 16), dtype=np.float32)
                  for _ in range(3))
    for e in (eng, jeng):
        e.upscale_batch(x1)
    assert eng._quant_fwd is None
    y2, j2 = eng.upscale_batch(x2), jeng.upscale_batch(x2)
    assert eng._quant_fwd is not None
    np.testing.assert_allclose(y2, plain.upscale_batch(x2), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(y2, j2, rtol=1e-5, atol=1e-5)
    assert eng._quant_batches == jeng._quant_batches == {"bf16": 2,
                                                         "int8": 0}
    assert eng._tta_on_device()
    eng.upscale_batch(x3)
    jeng.upscale_batch(x3)
    assert eng._quant_batches == jeng._quant_batches == {"bf16": 2,
                                                         "int8": 1}


@pytest.mark.parametrize("out_dtype", ["uint8", "int16"])
def test_tta_packs_the_mean(jax_params, out_dtype):
    x = np.random.default_rng(6).random((2, 16, 16), dtype=np.float32)
    got = _port(jax_params, tta=True, out_dtype=out_dtype).upscale_batch(x)
    want = _jax(jax_params, tta=True, out_dtype=out_dtype).upscale_batch(x)
    mean = _port(jax_params, tta=True).upscale_batch(x)
    scale = 255.0 if out_dtype == "uint8" else 32767.0
    assert got.dtype == want.dtype == np.dtype(out_dtype)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(
        got, np.round(np.clip(mean, 0, 1) * scale).astype(out_dtype))
