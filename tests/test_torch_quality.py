"""The port's quality tooling against the JAX package's on the CPU:
``ops/metrics.match_histograms`` (device version), ``metric_suites``
against JAX's ``metric_suite``, ``evalsuite/baselines.py``, the harness's
``make_volume`` against ``tools/quality_parity.make_volume`` (cv2's
bicubic, here the port's ``resize``), and a tiny ``tools/quality --cpu``
run whose report holds every row."""

import importlib.util
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.evalsuite import baselines as jb
from mri_superresolution_tpu.ops import metrics as jm
from mri_superresolution_torch.evalsuite import baselines as tb
from mri_superresolution_torch.ops import metrics as tm
from mri_superresolution_torch.tools import quality

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def package_logger():
    """Restore the port's logger after a test whose CLI set it up (its
    handlers and propagation), so that later tests in this process see
    logging as before."""
    logger = logging.getLogger("mri_superresolution_torch")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    yield
    for h in logger.handlers[:]:
        if h not in saved[0]:
            logger.removeHandler(h)
            h.close()
    logger.propagate, logger.level = saved[1], saved[2]


@pytest.mark.parametrize("shape", [(40, 33), (64, 64)])
@pytest.mark.parametrize("ties", [False, True])
def test_match_histograms_matches_jax(shape, ties):
    """The sort-based match of one image onto a reference: JAX's values
    (its ``jnp.interp`` rounding), ties among the source values too."""
    rng = np.random.default_rng(0)
    a = rng.random(shape).astype(np.float32)
    if ties:
        a = np.round(a * 20) / 20
    b = (rng.random((30, 50)) ** 2).astype(np.float32)
    want = np.asarray(jm.match_histograms(jnp.asarray(a), jnp.asarray(b)))
    got = tm.match_histograms(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if not ties:     # distinct source values: the host version's result
        np.testing.assert_allclose(got.numpy(), tm.match_histograms_np(a, b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,noise", [((40, 33), 0.05), ((64, 48), 0.2),
                                         ((32, 32), 0.0)])
def test_metric_suite_matches_jax(shape, noise):
    """Every value of ``metric_suites`` on a batch is JAX's
    ``metric_suite`` of that pair (rtol 1e-5), and ``metric_suites`` of one
    (H, W) pair is the batch's row; a perfect pair gives the 100 dB
    sentinel."""
    rng = np.random.default_rng(1)
    o = rng.random((3, *shape)).astype(np.float32)
    t = np.clip(o + noise * rng.standard_normal(o.shape), 0, 1).astype(
        np.float32)
    got = tm.metric_suites(torch.from_numpy(o), torch.from_numpy(t))
    assert len(got) == 3
    for i in range(3):
        want = jm.metric_suite(jnp.asarray(o[i]), jnp.asarray(t[i]))
        assert set(got[i]) == set(want)
        for k, v in want.items():
            assert got[i][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
        assert tm.metric_suites(torch.from_numpy(o[i]),
                                torch.from_numpy(t[i])) == [got[i]]
    if noise == 0.0:
        assert all(m["psnr"] == 100.0 and m["mse"] == 0.0 for m in got)


@pytest.mark.parametrize("method", jb.INTERP_METHODS)
@pytest.mark.parametrize("shape", [(33, 40), (2, 16, 24)])
def test_baselines_match_jax(method, shape):
    """bilinear and bicubic within 1e-6, sharp-bilinear within 1e-5 (the
    3x3 sums of values up to 9 in another order) on [0, 1] images."""
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    want = np.asarray(jb.upscale_with_interpolation(jnp.asarray(x), method))
    got = tb.upscale_with_interpolation(torch.from_numpy(x), method).numpy()
    assert got.shape == want.shape == (*shape[:-2], 2 * shape[-2],
                                       2 * shape[-1])
    tol = 1e-5 if method == "sharp_bilinear" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(tb.sharpen3x3(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.sharpen3x3(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tb.upscale_with_interpolation(torch.from_numpy(x), "lanczos")


def test_make_volume_matches_the_jax_harness():
    """The same generator draws as ``tools/quality_parity.make_volume``,
    with cv2's float bicubic texture upsampling replaced by the port's
    ``resize``: values within 1e-3 of ~800."""
    pytest.importorskip("cv2")
    spec = importlib.util.spec_from_file_location(
        "quality_parity", os.path.join(ROOT, "tools", "quality_parity.py"))
    qp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qp)
    want = qp.make_volume(np.random.default_rng(5), (40, 48, 12))
    got = quality.make_volume(np.random.default_rng(5), (40, 48, 12))
    assert got.shape == want.shape == (40, 48, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_quality_harness_reports_every_row(tmp_path, package_logger):
    """A tiny CPU run of the whole protocol (volumes of 160 x 160 x 40, 6
    slices each, LR 16^2 -> HR 32^2, one epoch of ``simple``, and one
    epoch of each QAT run): the report holds the bf16, int8 (PTQ) and TTA
    rows, the QAT rows (trained with --qat, and the --qat --resume
    fine-tune of the bf16 run, each served int8 from its sidecar and
    bf16) and the three baselines, each row with its metrics and deltas;
    int8 served every held-out pair after its calibration (int8, or bf16
    where near-empty), the QAT int8 rows with no calibration forward.
    """
    report = quality.main([
        "--workdir", str(tmp_path), "--cpu", "--hr_size", "32",
        "--n_slices", "6", "--n_train_volumes", "2", "--n_test_volumes", "1",
        "--epochs", "1", "--models", "simple", "--batch_size", "4",
        "--ft_epochs", "1"])
    rows = report["rows"]
    assert list(rows) == ["simple/bf16", "simple/int8", "simple/tta",
                          "simple/qat-int8", "simple/qat-bf16",
                          "simple/qat-ft-int8", "simple/qat-ft-bf16",
                          "baseline/bilinear", "baseline/sharp_bilinear",
                          "baseline/bicubic"]
    for name, row in rows.items():
        for k in quality.METRICS:
            assert np.isfinite(row[k]) and np.isfinite(row[f"delta_{k}"])
        assert row["delta_vs"] == "simple/bf16"
    assert rows["simple/bf16"]["delta_psnr"] == 0.0
    assert rows["simple/int8"]["served"]["int8"] + \
        rows["simple/int8"]["served"]["bf16"] == report["n_test_pairs"] == 6
    assert rows["simple/int8"]["calibration_forwards"] >= quality.CALIB_SLICES
    for tag in ("qat", "qat-ft"):
        q = rows[f"simple/{tag}-int8"]
        assert q["calibration_forwards"] == 0
        assert q["served"]["int8"] + q["served"]["bf16"] == 6
        assert os.path.exists(tmp_path / ("ckpt_qat" if tag == "qat" else
                                          "ckpt_ft_simple")
                              / "best_model_simple.calib.json")
    assert report["device"] == "cpu"
    with open(tmp_path / "quality.json") as f:
        assert json.load(f)["rows"] == rows
