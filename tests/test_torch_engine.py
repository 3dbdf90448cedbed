"""The port's serving engine and CLI against the JAX package's, on the CPU
(``device="cpu"``, fp32), with the same params in both."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.infer import InferenceEngine as JaxEngine
from mri_superresolution_tpu.infer import preprocess_image_array as jax_pre
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_torch.cli import infer as cli
from mri_superresolution_torch.config import ModelConfig, to_dict
from mri_superresolution_torch.infer import (InferenceEngine,
                                             preprocess_image_array)
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.train.checkpoint import save_checkpoint
from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    params = init_params(JaxUNet(base_filters=16), jax.random.key(0),
                         (16, 16))
    return jax.tree_util.tree_map(np.asarray, params)


def _engines(params, **kw):
    jeng = JaxEngine(JaxModelConfig(base_filters=16), params, bf16=False,
                     num_devices=1, **kw)
    teng = InferenceEngine(ModelConfig(base_filters=16),
                           state_dict_from_jax(params), bf16=False,
                           device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("bucket", [1, 32])
def test_upscale_batch_matches_jax(jax_params, bucket):
    rng = np.random.default_rng(0)
    jeng, teng = _engines(jax_params, bucket=bucket)
    x = rng.random((3, 27, 35)).astype(np.float32)
    got = teng.upscale_batch(x)
    want = jeng.upscale_batch(x)
    assert got.shape == want.shape == (3, 54, 70)
    assert got.dtype == np.float32
    # GroupNorm's E[x^2] - mean^2 cancels in fp32, and the two frameworks
    # sum in other orders: on a bucket's constant zero padding each is off
    # a float64 reference by up to ~4e-5 at the first stage, so the padded
    # case is held to atol 1e-4; the unpadded case to the model's 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 if bucket == 1 else 1e-4)
    np.testing.assert_allclose(teng.upscale_image(x[1]), got[1], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("out_dtype", ["uint8", "int16"])
def test_upscale_batch_packs_like_jax(jax_params, out_dtype):
    rng = np.random.default_rng(1)
    jeng, teng = _engines(jax_params, out_dtype=out_dtype)
    x = rng.random((2, 16, 24)).astype(np.float32)
    got = teng.upscale_batch(x)
    want = jeng.upscale_batch(x)
    assert got.dtype == want.dtype == np.dtype(out_dtype)
    # fp32 differences of ~1e-6 may move a value across a rounding edge
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("target_hw", [(32, 32), (30, 27)])
def test_calculate_metrics_matches_jax(target_hw):
    rng = np.random.default_rng(2)
    out = rng.random((32, 32)).astype(np.float32)
    target = np.clip(rng.random(target_hw).astype(np.float32), 0, 1)
    got = InferenceEngine.calculate_metrics(out, target, device="cpu")
    want = JaxEngine.calculate_metrics(out, target)
    assert set(got) == set(want) == {"ssim", "rmse", "mae"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k


def test_preprocess_matches_jax():
    img = np.random.default_rng(3).integers(0, 255, (40, 44)).astype(
        np.float32)
    np.testing.assert_array_equal(preprocess_image_array(img), jax_pre(img))


def test_unported_options_raise(jax_params):
    """Options the port does not serve raise NotImplementedError naming
    their ROADMAP item; combinations the JAX engine refuses raise
    ValueError, as there."""
    sd = state_dict_from_jax(jax_params)
    for kw, err, match in (
            ({"transpose_io": True}, ValueError, "transpose_io requires"),
            ({"normalize_inputs": True, "transpose_io": True, "tta": True},
             ValueError, "does not compose with tta"),
            ({"spatial_shards": 2}, NotImplementedError, "A14"),
            ({"quant": "int8", "normalize_inputs": True}, ValueError,
             "normalize_inputs is incompatible"),
            ({"out_dtype": "float16"}, ValueError, "out_dtype")):
        with pytest.raises(err, match=match):
            InferenceEngine(ModelConfig(base_filters=16), sd, device="cpu",
                            **kw)


def test_entry_points_want_the_card():
    """Without a GPU, an entry point that was not asked for the CPU
    raises instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cpu"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_process_single_image_matches_jax(tmp_path, jax_params):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    inp = rng.integers(0, 255, (24, 24), dtype=np.uint8)
    tgt = rng.integers(0, 255, (48, 40), dtype=np.uint8)
    ipath, tpath = str(tmp_path / "in.png"), str(tmp_path / "tgt.png")
    cv2.imwrite(ipath, inp)
    cv2.imwrite(tpath, tgt)
    jeng, teng = _engines(jax_params)
    out, metrics = teng.process_single_image(
        ipath, str(tmp_path / "t.png"), tpath, show_diff=True,
        save_figures_to=str(tmp_path / "fig.png"))
    jout, jmetrics = jeng.process_single_image(ipath, str(tmp_path / "j.png"),
                                               tpath)
    assert out.shape == (48, 48)
    # histogram matching maps ranks to target quantiles, so two near-equal
    # outputs may swap neighbours: a pixel moves by at most about one
    # 8-bit gray level of the target
    diff = np.abs(out - jout)
    assert diff.max() <= 1.0 / 255 and diff.mean() <= 1e-4
    for k in jmetrics:
        assert abs(metrics[k] - jmetrics[k]) <= 1e-4, k
    assert os.path.exists(tmp_path / "fig.png")
    saved = cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_GRAYSCALE)
    jsaved = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_GRAYSCALE)
    assert np.abs(saved.astype(int) - jsaved.astype(int)).max() <= 1


@pytest.mark.parametrize("family", ["simple", "unet_tpu", "edsr"])
def test_cli_serves_every_family(tmp_path, family):
    """``--model_type`` serves a checkpoint of each family (port-written,
    seeded weights, hyperparams from its sidecar): the PNG is the fp32
    engine's output within one gray level."""
    cv2 = pytest.importorskip("cv2")
    cfg = ModelConfig(model_type=family, base_filters=8, num_blocks=2)
    sd = build_model(cfg, generator=torch.Generator().manual_seed(0)
                     ).state_dict()
    save_checkpoint(str(tmp_path / f"best_model_{family}"), sd,
                    meta={"config": {"model": to_dict(cfg)}})
    inp = np.random.default_rng(6).integers(0, 255, (16, 24), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), inp)
    out = str(tmp_path / "out.png")
    assert cli.main(["--input", str(tmp_path / "in.png"), "--output", out,
                     "--checkpoint_dir", str(tmp_path), "--model_type",
                     family, "--cpu", "--no_bf16"]) == 0
    eng = InferenceEngine(cfg, sd, bf16=False, device="cpu")
    want = eng.upscale_image(preprocess_image_array(inp))
    got = cv2.imread(out, cv2.IMREAD_GRAYSCALE)
    assert got.shape == (32, 48)
    assert np.abs(got.astype(float) - want * 255.0).max() <= 1.0


class _Logs(logging.Handler):
    """The port's log lines while attached (its logger does not
    propagate to pytest's caplog)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.text = ""

    def emit(self, record):
        self.text += record.getMessage() + "\n"

    def __enter__(self):
        logging.getLogger("mri_superresolution_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("mri_superresolution_torch").removeHandler(self)


@pytest.mark.parametrize("flags,item", [
    (["--artifact", "model.mrisrx"], "JAX package")])
def test_cli_refuses_unported_flags(tmp_path, flags, item):
    """``--artifact`` is served since ROADMAP A12; what the port does not
    serve is a JAX package's artifact (jax.export programs): exit 1,
    naming the package."""
    (tmp_path / flags[1]).write_bytes(b"MRISRX1\n" + b"\0" * 16)
    argv = ["--input", "x.png", "--output", str(tmp_path / "o.png"), "--cpu",
            flags[0], str(tmp_path / flags[1])]
    with _Logs() as logs:
        assert cli.main(argv) == 1
    assert item in logs.text


def test_cli_serves_a_jax_checkpoint(tmp_path, jax_params):
    cv2 = pytest.importorskip("cv2")
    d = str(tmp_path)
    jax_ckpt.save_checkpoint(os.path.join(d, "best_model_unet"), jax_params,
                             meta={"config": {"model": {
                                 "model_type": "unet", "base_filters": 16}}})
    inp = np.random.default_rng(5).integers(0, 255, (16, 24), dtype=np.uint8)
    cv2.imwrite(os.path.join(d, "in.png"), inp)
    out = os.path.join(d, "out.png")
    assert cli.main(["--input", os.path.join(d, "in.png"), "--output", out,
                     "--checkpoint_dir", d, "--cpu", "--no_bf16"]) == 0
    assert cv2.imread(out, cv2.IMREAD_GRAYSCALE).shape == (32, 48)
    # no checkpoint -> logged error, exit 1
    assert cli.main(["--input", os.path.join(d, "in.png"), "--output", out,
                     "--checkpoint_dir", str(tmp_path / "none"),
                     "--cpu"]) == 1
