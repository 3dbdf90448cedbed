"""Row-sharded serving through the port's engine, artifacts and CLIs,
against the port's dense engine and the JAX package's spatial engine, on
the CPU (``devices=[cpu] * n``, the JAX tests' 8 host devices).

Tolerances are the JAX tests' (``tests/test_spatial.py``): fp32 within
rtol 1e-4, atol 3e-5 of the dense engine; int8 unets within the quality
contract against the fp32 truth, since a GroupNorm sum taken in another
order can flip an int8 code.
"""

import io
import json
import logging
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.infer.engine import InferenceEngine as JaxEngine
from mri_superresolution_tpu.models import build_model as jax_build_model
from mri_superresolution_tpu.models import init_params
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer.engine import InferenceEngine
from mri_superresolution_torch.infer.export import (export_artifact,
                                                    load_artifact)
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(n, h, w, seed=0):
    return np.random.default_rng(seed).random((n, h, w), np.float32)


@pytest.fixture(scope="module")
def families():
    """JAX params (the JAX tests' seeds) and the port's state_dict."""
    out = {}
    for mt, seed in (("unet", 0), ("unet_tpu", 1)):
        model = jax_build_model(JaxModelConfig(model_type=mt,
                                               base_filters=16),
                                dtype=jnp.float32)
        params = jax.tree_util.tree_map(
            np.asarray, init_params(model, jax.random.key(seed), (32, 32)))
        out[mt] = (params, state_dict_from_jax(params, mt))
    return out


def _engine(sd, n=8, shards=4, model_type="unet", **kw):
    return InferenceEngine(ModelConfig(model_type=model_type,
                                       base_filters=16), sd, bf16=False,
                           devices=[CPU] * n, spatial_shards=shards, **kw)


def _dense(sd, model_type="unet", **kw):
    return InferenceEngine(ModelConfig(model_type=model_type,
                                       base_filters=16), sd, bf16=False,
                           device="cpu", **kw)


def _assert_int8_quality(sp, dense, truth):
    e_sp = np.abs(np.asarray(sp, np.float32) - np.asarray(truth, np.float32))
    e_d = np.abs(np.asarray(dense, np.float32)
                 - np.asarray(truth, np.float32))
    assert e_sp.mean() <= 1.1 * e_d.mean() + 1e-5, \
        f"mean {e_sp.mean()} vs dense {e_d.mean()}"
    assert np.quantile(e_sp, 0.999) <= 1.2 * np.quantile(e_d, 0.999) + 1e-3


def _assert_int8_close(a, b):
    """The JAX tests' contract for one int8 path against itself (TTA's
    flip equivariance): nearly every pixel tight, flips rare and small."""
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert d.mean() < 1e-4, f"mean err {d.mean()}"
    assert (d > 1e-3).mean() < 0.01, f"flip fraction {(d > 1e-3).mean()}"
    assert d.max() < 0.1, f"max err {d.max()}"


@pytest.mark.parametrize("model_type", ["unet", "unet_tpu"])
def test_engine_matches_dense_and_jax(families, model_type):
    """``spatial_shards=4`` over 8 CPU devices (2 data x 4 space): the
    dense engine's output and the JAX spatial engine's, fp32."""
    params, sd = families[model_type]
    batch = _rand(4, 64, 64, seed=3)
    eng = _engine(sd, model_type=model_type)
    assert (eng.n_devices, eng.spatial_shards) == (2, 4)
    got = eng.upscale_batch(batch)
    np.testing.assert_allclose(
        got, _dense(sd, model_type).upscale_batch(batch), rtol=1e-4,
        atol=3e-5)
    want = JaxEngine(JaxModelConfig(model_type=model_type, base_filters=16),
                     params, bf16=False, num_devices=8,
                     spatial_shards=4).upscale_batch(batch)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-5)


def test_engine_rejects_bad_config(families):
    _, sd = families["unet"]
    with pytest.raises(ValueError, match="must divide the 8 mesh devices"):
        _engine(sd, shards=3)
    with pytest.raises(ValueError, match="Unknown model type"):
        InferenceEngine(ModelConfig(model_type="hourglass"), sd,
                        devices=[CPU] * 2, spatial_shards=2)


class _Warnings(logging.Handler):
    """The WARNING records of one logger, held on that logger itself: a
    CLI run earlier in the process may have stopped its records from
    reaching the root."""

    def __init__(self, name):
        super().__init__(logging.WARNING)
        self.logger, self.messages = logging.getLogger(name), []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def test_engine_padding_warns(families):
    """A non-conforming size is zero-padded to H % (8 * shards) and W % 8,
    which moves every GroupNorm's statistics: the engine says so, once a
    shape, and not for a conforming size."""
    _, sd = families["unet"]
    eng = _engine(sd)
    with _Warnings("mri_superresolution_torch.infer") as logs:
        out = eng.upscale_batch(_rand(2, 40, 40, seed=5))
        eng.upscale_batch(_rand(2, 40, 40, seed=6))
        eng.upscale_batch(_rand(2, 64, 64, seed=6))
    assert out.shape == (2, 80, 80)
    warns = [m for m in logs.messages if "GroupNorm" in m]
    assert len(warns) == 1 and "40x40" in warns[0] and "64x40" in warns[0]


def test_tta_composes_with_spatial_serving(families):
    """The dihedral ensemble's members through the spatial forward:
    flip-equivariant, and the dense engine's ensemble to fp32
    tolerance."""
    _, sd = families["unet"]
    eng = _engine(sd, n=4, shards=2, tta=True)
    x = _rand(2, 32, 32, seed=3)
    y = eng.upscale_batch(x)
    assert y.shape == (2, 64, 64) and np.isfinite(y).all()
    yf = eng.upscale_batch(np.ascontiguousarray(x[:, ::-1]))
    np.testing.assert_allclose(yf[:, ::-1], y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, _dense(sd, tta=True).upscale_batch(x),
                               rtol=1e-4, atol=3e-5)


def _sidecar(tmp_path, sd, batch):
    path = str(tmp_path / "scales.calib.json")
    scales = qf.calibrate(sd, [batch[..., None]], "unet", torch.float32)
    qf.save_scales(path, scales, "unet")
    return path


def test_int8_frozen_sidecar_matches_dense(tmp_path, families):
    """Engines on one frozen sidecar serve int8 from batch 0, dense and
    row-sharded, within the quality contract of each other."""
    _, sd = families["unet"]
    rich = _rand(4, 64, 64, seed=6)
    path = _sidecar(tmp_path, sd, rich)
    dense = _dense(sd, quant="int8", quant_calib_path=path)
    sp = _engine(sd, quant="int8", quant_calib_path=path)
    yd, ys = dense.upscale_batch(rich), sp.upscale_batch(rich)
    assert dense._quant_batches["int8"] == sp._quant_batches["int8"] == 1
    _assert_int8_quality(ys, yd, _dense(sd).upscale_batch(rich))


def test_int8_streaming_calibration(families):
    """The row-sharded engine calibrates while it serves, freezes, and
    serves int8: the dense engine's scales (fp32 forward; a max does not
    depend on its order) and its quality."""
    _, sd = families["unet"]
    rich = _rand(4, 64, 64, seed=7)
    sp = _engine(sd, quant="int8", quant_calib_slices=4)
    assert sp.quant_calibrating
    y0 = sp.upscale_batch(rich)            # calibrates and re-serves int8
    assert not sp.quant_calibrating
    assert sp._quant_batches["int8"] == 1
    assert "scales frozen" in sp.quant_summary()
    dense = _dense(sd, quant="int8", quant_calib_slices=4)
    dense.upscale_batch(rich)
    for k, v in dense._quant_scales.items():
        np.testing.assert_allclose(sp._quant_scales[k], v, rtol=1e-5,
                                   atol=1e-7)
    _assert_int8_quality(y0, dense.upscale_batch(rich),
                         _dense(sd).upscale_batch(rich))


def test_int8_routes_near_empty_to_the_plain_forward(tmp_path, families):
    """A near-empty batch serves on the spatial plain forward, equal to a
    row-sharded engine without int8."""
    _, sd = families["unet"]
    path = _sidecar(tmp_path, sd, _rand(2, 64, 64, seed=8))
    empty = np.zeros((2, 64, 64), np.float32)
    empty[:, 30:32, 30:32] = 1.0          # ~0.1% foreground
    q = _engine(sd, quant="int8", quant_calib_path=path)
    np.testing.assert_array_equal(q.upscale_batch(empty),
                                  _engine(sd).upscale_batch(empty))
    assert q._quant_batches == {"bf16": 1, "int8": 0}


def test_tta_composes_with_spatial_int8(tmp_path, families):
    """Frozen int8 + spatial + TTA: the ensemble around the row-sharded
    int8 forward, flip-equivariant, counted as one int8 batch."""
    _, sd = families["unet"]
    rich = _rand(2, 32, 32, seed=9)
    eng = _engine(sd, n=4, shards=2, quant="int8", tta=True,
                  quant_calib_path=_sidecar(tmp_path, sd, rich))
    assert eng._tta_on_device()
    y = eng.upscale_batch(rich)
    assert y.shape == (2, 64, 64) and np.isfinite(y).all()
    assert eng._quant_batches["int8"] == 1
    yf = eng.upscale_batch(np.ascontiguousarray(rich[:, ::-1]))
    _assert_int8_close(yf[:, ::-1], y)


def test_int8_bad_sidecar_fails_at_init(tmp_path, families):
    _, sd = families["unet"]
    scales = qf.calibrate(sd, [np.zeros((1, 32, 32, 1), np.float32)],
                          "unet", torch.float32)
    scales.pop("inc.conv1")
    path = str(tmp_path / "bad.calib.json")
    qf.save_scales(path, scales, "unet")
    with pytest.raises(ValueError, match="missing for sites"):
        _engine(sd, quant="int8", quant_calib_path=path)


@pytest.fixture(scope="module")
def spatial_artifact(families, tmp_path_factory):
    """A (1 data x 2 space) fp32 unet artifact of 32^2 at a fixed batch
    of 2."""
    _, sd = families["unet"]
    path = str(tmp_path_factory.mktemp("art") / "sp.mrisrt")
    export_artifact(path, sd, ModelConfig(base_filters=16), [(32, 32)],
                    bf16=False, spatial_shards=2, spatial_devices=2,
                    spatial_batch=2)
    return path


def test_spatial_artifact_round_trip(spatial_artifact, families):
    """The artifact serves a batch of 3 (two calls, the last padded) bit
    for bit as the spatial engine on a pool of two; its header records the
    grid; it serves no other shape, and a pool of another size is
    refused."""
    _, sd = families["unet"]
    art = load_artifact(spatial_artifact, device="cpu", devices=[CPU] * 2)
    assert art.spatial == {"n_data": 1, "n_space": 2, "batch": 2,
                           "devices": 2}
    batch = _rand(3, 32, 32, seed=4)
    got = art.upscale_batch(batch)
    assert got.shape == (3, 64, 64)
    np.testing.assert_array_equal(got, _engine(sd, n=2, shards=2)
                                  .upscale_batch(batch))
    with pytest.raises(ValueError, match="cannot serve it by padding"):
        art.upscale_batch(_rand(1, 16, 16), pad=True)
    with pytest.raises(ValueError, match="the loader's pool has 4"):
        load_artifact(spatial_artifact, device="cpu", devices=[CPU] * 4)


def test_spatial_artifact_through_the_daemon_batcher(spatial_artifact):
    """The daemon's batcher on a row-sharded artifact: three slices
    coalesce (padded to a batch of 4, two program calls) and come back as
    the artifact's own ``upscale_batch``."""
    from mri_superresolution_torch.infer.server import DynamicBatcher
    art = load_artifact(spatial_artifact, device="cpu")
    b = DynamicBatcher(art, max_batch=4, batch_window_ms=100.0)
    try:
        batch = _rand(3, 32, 32, seed=11)
        reqs = [b.submit(s) for s in batch]
        outs = np.stack([b.wait(r, timeout=300) for r in reqs])
        np.testing.assert_array_equal(outs, art.upscale_batch(batch))
        assert b.stats["max_batch_seen"] == 3
    finally:
        b.close()


def _write_volume(path, seed=0):
    from mri_superresolution_torch import nifti
    vol = (np.random.default_rng(seed).random((24, 20, 4)) * 1800).astype(
        np.int16)
    nifti.save(str(path), vol, zooms=(1.0, 1.0, 2.0))


def test_infer_volume_cli_matches_jax(tmp_path, families, monkeypatch):
    """``--cpu --num_devices 4 --spatial_shards 2 --no_bf16``: a 24 x 20
    volume (rows padded to 32, with the warning) within rtol 1e-4, atol
    1e-5 of the JAX CLI with the same flags."""
    import importlib.util
    from mri_superresolution_tpu import nifti as jnifti
    from mri_superresolution_torch.cli import infer_volume as cli

    params, sd = families["unet"]
    monkeypatch.chdir(tmp_path)
    ckpt.save_checkpoint(str(tmp_path / "final_model_unet"), sd, meta={
        "config": {"model": {"model_type": "unet", "base_filters": 16}}})
    _write_volume(tmp_path / "v.nii")
    common = ["--input", "v.nii", "--checkpoint_dir", str(tmp_path),
              "--cpu", "--no_bf16", "--num_devices", "4",
              "--spatial_shards", "2", "--batch_size", "3"]
    assert cli.main(common + ["--output", "port.nii"]) == 0
    spec = importlib.util.spec_from_file_location(
        "jax_infer_volume", os.path.join(ROOT, "scripts", "infer_volume.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["infer_volume.py", *common,
                                      "--output", "jax.nii"])
    assert mod.main() == 0
    got, _ = jnifti.load("port.nii")
    want, _ = jnifti.load("jax.nii")
    assert got.shape == want.shape == (48, 40, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_serve_cli_serves_spatial(tmp_path, families):
    """``--cpu --num_devices 2 --spatial_shards 2``: /healthz names the
    grid, and /upscale answers the spatial engine's output."""
    import socket
    _, sd = families["unet"]
    ckpt.save_checkpoint(str(tmp_path / "final_model_unet"), sd, meta={
        "config": {"model": {"model_type": "unet", "base_filters": 16}}})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mri_superresolution_torch.cli.serve",
         "--checkpoint_dir", str(tmp_path), "--port", str(port), "--cpu",
         "--no_bf16", "--num_devices", "2", "--spatial_shards", "2",
         "--max_batch", "2"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT,
                                    OMP_NUM_THREADS="2"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        import time
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.5)
        assert "spatial=2" in json.dumps(health)
        x = _rand(2, 32, 32, seed=2)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(base + "/upscale", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))
        np.testing.assert_array_equal(
            got, _engine(sd, n=2, shards=2).upscale_batch(x))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stderr.close()
