"""The port engine's int8 serving state machine (``quant="int8"``) on the
CPU, case for case with the JAX engine's tests (tests/test_quant.py): the
streaming self-calibration, the freeze and its sidecar, the re-serve of a
batch that completes calibration, the near-empty bf16 routing, and the
CLI's ``--quant int8`` / ``--quant_calib``. The JAX package reads the
sidecars the port writes."""

import os

import jax
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_torch.cli import infer as cli
from mri_superresolution_torch.config import InferConfig, ModelConfig
from mri_superresolution_torch.infer import InferenceEngine, load_engine
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.weights import jax_params_from_state_dict

torch.set_num_threads(2)

CFG = ModelConfig(base_filters=16)


@pytest.fixture(scope="module")
def params():
    return build_model(CFG, generator=torch.Generator().manual_seed(0)
                       ).state_dict()


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _engine(params, **kw):
    return InferenceEngine(CFG, params, device="cpu", **kw)


def _near_empty():
    empty = np.zeros((2, 40, 40), np.float32)
    empty[:, 18:20, 18:20] = 1.0                 # 0.25% foreground
    return empty


def test_engine_int8_serving_close_to_bf16(params, rng):
    batch = rng.random((3, 40, 40), np.float32)
    base = _engine(params).upscale_batch(batch)
    qeng = _engine(params, quant="int8", quant_calib_slices=4)
    calib = qeng.upscale_batch(batch)      # 3 < 4 slices: bf16 calib serve
    assert qeng.quant_calibrating and qeng._quant_fwd is None
    # the calib forward is the bf16 forward, bit for bit, in this port
    np.testing.assert_array_equal(calib, base)
    mid = qeng.upscale_batch(batch)        # completes (6 >= 4): bf16 served,
    assert qeng._quant_fwd is not None     # int8 starts with the next batch
    np.testing.assert_array_equal(mid, base)
    q = qeng.upscale_batch(batch)          # int8-served
    assert q.shape == base.shape == (3, 80, 80)
    assert np.isfinite(q).all() and q.min() >= 0.0 and q.max() <= 1.0
    assert 0.0 < np.abs(q - base).mean() < 0.05
    assert qeng._quant_batches == {"int8": 1, "bf16": 2}
    assert not qeng.quant_calibrating


def test_engine_single_batch_calibration_serves_int8(params, rng):
    batch = rng.random((2, 40, 40), np.float32)
    base = _engine(params).upscale_batch(batch)
    qeng = _engine(params, quant="int8", quant_calib_slices=1)
    out = qeng.upscale_batch(batch)
    assert qeng._quant_fwd is not None
    assert qeng._quant_batches == {"int8": 1, "bf16": 0}
    assert np.abs(out - base).mean() > 0.0       # int8, not the bf16 output
    assert "frozen" in qeng.quant_summary()


def test_engine_routes_near_empty_batches_to_bf16(params, rng):
    rich = rng.random((2, 40, 40), np.float32)
    base = _engine(params)
    qeng = _engine(params, quant="int8", quant_calib_slices=1)
    qeng.upscale_batch(rich)                     # calibrate + freeze
    routed = qeng.upscale_batch(_near_empty())   # bf16: identical
    np.testing.assert_array_equal(routed, base.upscale_batch(_near_empty()))
    q = qeng.upscale_batch(rich)                 # rich batch stays int8
    assert np.abs(q - base.upscale_batch(rich)).mean() > 0.0
    assert qeng._quant_batches == {"int8": 2, "bf16": 1}


def test_engine_near_empty_batches_do_not_calibrate(params):
    qeng = _engine(params, quant="int8", quant_calib_slices=1)
    out = qeng.upscale_batch(_near_empty())
    assert qeng._calib_seen == 0 and qeng._quant_fwd is None
    assert qeng._quant_batches["bf16"] == 1
    assert out.shape == (2, 80, 80)
    assert "INCOMPLETE" in qeng.quant_summary()


def test_engine_quant_with_bucket_padding(params, rng):
    """The foreground fraction comes from the real pixels, not the bucket's
    zero padding, so a content-rich odd-size batch still serves int8."""
    batch = rng.random((2, 40, 40), np.float32)     # pads to 64x64
    qeng = _engine(params, quant="int8", quant_calib_slices=1, bucket=64)
    out = qeng.upscale_batch(batch)
    assert qeng._quant_batches["int8"] == 1
    assert out.shape == (2, 80, 80)


def test_engine_quant_validation(params):
    with pytest.raises(ValueError, match="unknown quant"):
        _engine(params, quant="fp8")
    with pytest.raises(ValueError, match="supports model types"):
        InferenceEngine(ModelConfig(model_type="nope", base_filters=16),
                        params, device="cpu", quant="int8")
    with pytest.raises(ValueError, match="calib_slices"):
        _engine(params, quant="int8", quant_calib_slices=0)
    with pytest.raises(ValueError, match="incompatible"):
        _engine(params, quant="int8", normalize_inputs=True)


def test_engine_quant_calib_path_persistence(tmp_path, params, rng):
    """Run 1 self-calibrates and saves; runs 2 and 3 load the frozen
    scales, serve int8 from the first batch and give the same bytes."""
    batch = rng.random((2, 40, 40), np.float32)
    path = str(tmp_path / "calib.json")
    eng1 = _engine(params, quant="int8", quant_calib_slices=1,
                   quant_calib_path=path)
    assert eng1._quant_fwd is None
    out1 = eng1.upscale_batch(batch)
    assert os.path.exists(path)
    eng2 = _engine(params, quant="int8", quant_calib_slices=1,
                   quant_calib_path=path)
    assert eng2._quant_fwd is not None
    out2 = eng2.upscale_batch(batch)
    assert eng2._quant_batches == {"int8": 1, "bf16": 0}
    np.testing.assert_array_equal(out1, out2)
    eng3 = _engine(params, quant="int8", quant_calib_path=path)
    np.testing.assert_array_equal(out2, eng3.upscale_batch(batch))
    # the JAX engine's loader reads the port's sidecar
    scales, mtype = jqf.load_scales(path)
    assert mtype == "unet" and len(scales) == 20


def test_engine_quant_calib_path_model_mismatch(tmp_path, params):
    scales = {s: np.ones(w.shape[1], np.float32)
              for s, w in qf.quant_sites(params)}
    path = str(tmp_path / "calib.json")
    qf.save_scales(path, scales, "unet_tpu")
    with pytest.raises(ValueError, match="model type"):
        _engine(params, quant="int8", quant_calib_path=path)


@pytest.mark.parametrize("name", ["best_model_unet.ckpt", "model.pth",
                                  "final_model_unet"])
def test_calib_sidecar_path_matches_jax(name):
    path = os.path.join("ckpts", name)
    assert ckpt.calib_sidecar_path(path) == jax_ckpt.calib_sidecar_path(path)


def test_load_engine_serves_the_qat_sidecar(tmp_path, params, rng):
    """A checkpoint with a ``<base>.calib.json`` beside it serves int8 from
    the first batch with those scales."""
    d = str(tmp_path)
    base = os.path.join(d, "best_model_unet")
    jp = jax.tree_util.tree_map(np.asarray, jax_params_from_state_dict(
        params))
    jax_ckpt.save_checkpoint(base, jp, meta={"config": {"model": {
        "model_type": "unet", "base_filters": 16}}})
    # an engine that calibrates writes the sidecar where a QAT run would
    _engine(params, quant="int8", quant_calib_slices=1,
            quant_calib_path=ckpt.calib_sidecar_path(base + ".ckpt")
            ).upscale_batch(rng.random((1, 32, 32), np.float32))
    eng = load_engine(InferConfig(model=CFG, checkpoint_dir=d, quant="int8"),
                      device="cpu")
    assert eng._quant_fwd is not None
    eng.upscale_batch(rng.random((1, 24, 24), np.float32))
    assert eng._quant_batches == {"int8": 1, "bf16": 0}
    # without --quant the sidecar is not read
    plain = load_engine(InferConfig(model=CFG, checkpoint_dir=d),
                        device="cpu")
    assert plain.quant == "none" and plain._quant_fwd is None


def test_cli_quant_int8_writes_then_loads_the_sidecar(tmp_path, params,
                                                      caplog):
    cv2 = pytest.importorskip("cv2")
    d = str(tmp_path)
    torch.save(params, os.path.join(d, "best_model_unet.pth"))
    inp = np.random.default_rng(5).integers(0, 255, (24, 32), dtype=np.uint8)
    cv2.imwrite(os.path.join(d, "in.png"), inp)
    calib = os.path.join(d, "scales.json")
    argv = ["--input", os.path.join(d, "in.png"), "--checkpoint_dir", d,
            "--base_filters", "16", "--cpu", "--quant", "int8",
            "--quant_calib", calib]
    out1, out2 = os.path.join(d, "o1.png"), os.path.join(d, "o2.png")
    assert cli.main(argv + ["--output", out1]) == 0
    assert os.path.exists(calib)
    mtime = os.path.getmtime(calib)
    assert cli.main(argv + ["--output", out2]) == 0
    assert os.path.getmtime(calib) == mtime          # loaded, not rewritten
    a = cv2.imread(out1, cv2.IMREAD_GRAYSCALE)
    assert a.shape == (48, 64)
    np.testing.assert_array_equal(a, cv2.imread(out2, cv2.IMREAD_GRAYSCALE))
    scales, mtype = jqf.load_scales(calib)           # the JAX package reads it
    assert mtype == "unet" and len(scales) == 20
