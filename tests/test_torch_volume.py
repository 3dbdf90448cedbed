"""Whole-volume serving in the port against the JAX package, on the CPU
(``device="cpu"`` / ``--cpu``, fp32, base filters 16), with the same
params in both: the engine's ``normalize_inputs``, ``transpose_io``,
``upscale_batches`` and ``upscale_tiled``, ``InferConfig`` and
``load_engine``, and the ``infer_volume`` CLI against
``scripts/infer_volume.py``, both in this process. Case for case with the
JAX package's tests/test_infer.py and tests/test_cli.py."""

import dataclasses
import importlib.util
import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mri_superresolution_tpu import nifti as jnifti
from mri_superresolution_tpu.config import InferConfig as JaxInferConfig
from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.infer import InferenceEngine as JaxEngine
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_torch import config as tconfig
from mri_superresolution_torch import nifti
from mri_superresolution_torch.cli import infer_volume as cli
from mri_superresolution_torch.config import InferConfig, ModelConfig
from mri_superresolution_torch.infer import (InferenceEngine, load_engine,
                                             preprocess_image_array)
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _raw(dtype, hi, shape, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)


# ------------------------------------------------- normalize_inputs / io


@pytest.mark.parametrize("dtype,hi", [(np.uint16, 4000), (np.int16, 2000),
                                      (np.uint8, 255)])
@pytest.mark.parametrize("bucket", [1, 32])
def test_normalize_inputs_matches_jax(jax_params, dtype, hi, bucket):
    """Raw batches normalized on the device, then padded: the same as
    JAX's engine, and as the host normalize + the plain engine."""
    raw = _raw(dtype, hi, (3, 20, 20))
    got = _port(jax_params, normalize_inputs=True,
                bucket=bucket).upscale_batch(raw)
    want = _jax(jax_params, normalize_inputs=True,
                bucket=bucket).upscale_batch(raw)
    atol = 1e-5 if bucket == 1 else 1e-4   # the engine's bucket tolerance
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    host = np.stack([preprocess_image_array(s.astype(np.float32))
                     for s in raw])
    np.testing.assert_allclose(
        got, _port(jax_params, bucket=bucket).upscale_batch(host),
        rtol=1e-5, atol=1e-5)


def test_normalize_inputs_composes_with_tta(jax_params):
    raw = _raw(np.uint16, 4000, (2, 16, 16), seed=1)
    got = _port(jax_params, tta=True, normalize_inputs=True
                ).upscale_batch(raw)
    want = _jax(jax_params, tta=True, normalize_inputs=True
                ).upscale_batch(raw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    host = np.stack([preprocess_image_array(s.astype(np.float32))
                     for s in raw])
    np.testing.assert_allclose(
        got, _port(jax_params, tta=True).upscale_batch(host), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("dtype,hi", [(np.uint16, 4000), (np.int16, 2000),
                                      (np.uint8, 255)])
@pytest.mark.parametrize("bucket", [1, 32])
def test_transpose_io_matches_jax(jax_params, dtype, hi, bucket):
    """(N, w, h) in, C-contiguous (N, 2w, 2h) out, both swaps on the
    device; values as the standard layout's and as JAX's."""
    raw = _raw(dtype, hi, (3, 24, 16), seed=2)                 # (n, w, h)
    eng = _port(jax_params, normalize_inputs=True, transpose_io=True,
                bucket=bucket)
    got = eng.upscale_batch(raw)
    assert got.shape == (3, 48, 32) and got.flags.c_contiguous
    assert got.T.flags.f_contiguous
    want = _jax(jax_params, normalize_inputs=True, transpose_io=True,
                bucket=bucket).upscale_batch(raw)
    atol = 1e-5 if bucket == 1 else 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    std = _port(jax_params, normalize_inputs=True, bucket=bucket
                ).upscale_batch(np.ascontiguousarray(raw.swapaxes(1, 2)))
    np.testing.assert_array_equal(got.swapaxes(1, 2), std)
    packed = _port(jax_params, normalize_inputs=True, transpose_io=True,
                   bucket=bucket, out_dtype="int16").upscale_batch(raw)
    assert packed.dtype == np.int16 and packed.shape == (3, 48, 32)
    assert np.abs(packed.astype(np.int32) - np.round(
        got * 32767).astype(np.int32)).max() <= 1


def test_transpose_io_reads_a_volume_buffer_in_place(jax_params, tmp_path):
    """A volume straight from ``nifti.load(raw=True)`` is a read-only
    F-order buffer: its ``.T`` is served with no host copy."""
    vol = _raw(np.int16, 3000, (16, 24, 3), seed=3)
    path = str(tmp_path / "v.nii")
    nifti.save(path, vol, scl_slope=0.5)
    data, _ = nifti.load(path, raw=True)
    assert not data.flags.writeable and data.T.flags.c_contiguous
    eng = _port(jax_params, normalize_inputs=True, transpose_io=True)
    sr = eng.upscale_batch(data.T)
    want = _port(jax_params, normalize_inputs=True).upscale_batch(
        np.ascontiguousarray(np.transpose(vol, (2, 0, 1))))
    np.testing.assert_array_equal(np.transpose(sr.T, (2, 0, 1)), want)


def test_page_locked_leaves_a_cpu_batch_as_it_is(jax_params):
    """On the CPU there is nothing to page-lock: the array comes back as
    it is and serves the same bits."""
    raw = _raw(np.int16, 3000, (3, 16, 24), seed=5)
    eng = _port(jax_params, normalize_inputs=True)
    with eng.page_locked(raw) as locked:
        assert locked is raw
        got = eng.upscale_batch(locked)
    np.testing.assert_array_equal(got, eng.upscale_batch(raw))


# ------------------------------------------------------- upscale_batches


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kw", [{}, {"tta": True},
                                {"out_dtype": "uint8"},
                                {"normalize_inputs": True},
                                {"normalize_inputs": True,
                                 "transpose_io": True, "bucket": 32}],
                         ids=["plain", "tta", "uint8", "normalize",
                              "transpose_io"])
@pytest.mark.parametrize("depth", [1, 2])
def test_upscale_batches_matches_sequential(jax_params, kw, depth):
    """The window yields exactly map(upscale_batch), array for array, over
    mixed shapes."""
    rng = np.random.default_rng(4)
    shapes = [(2, 16, 16), (3, 24, 16), (1, 16, 16), (2, 16, 16)]
    if kw.get("normalize_inputs"):
        batches = [(rng.random(s) * 3000).astype(np.uint16) for s in shapes]
    else:
        batches = [rng.random(s, dtype=np.float32) for s in shapes]
    ref = [_port(jax_params, **kw).upscale_batch(b) for b in batches]
    eng = _port(jax_params, **kw)
    _same(list(eng.upscale_batches(iter(batches), depth=depth)), ref)


def test_upscale_batches_int8_freeze_mid_stream(jax_params):
    """The int8 state machine runs at dispatch time in batch order: bf16
    while calibrating, int8 after the freeze, batch for batch as the
    sequential loop (and as JAX's counts)."""
    kw = dict(quant="int8", quant_calib_slices=3, quant_min_foreground=0.0)
    rng = np.random.default_rng(5)
    batches = [rng.random((2, 16, 16), dtype=np.float32) for _ in range(4)]
    ref_eng, eng, jeng = (_port(jax_params, **kw), _port(jax_params, **kw),
                          _jax(jax_params, **kw))
    ref = [ref_eng.upscale_batch(b) for b in batches]
    _same(list(eng.upscale_batches(iter(batches))), ref)
    list(jeng.upscale_batches(iter(batches)))
    assert eng._quant_fwd is not None
    assert eng._quant_batches == ref_eng._quant_batches == \
        jeng._quant_batches == {"bf16": 2, "int8": 2}


def test_upscale_batches_host_loop_tta_flushes(jax_params):
    """While int8 calibrates, TTA batches run the host loop: the window is
    flushed and they run alone, with the same values and order; once the
    scales freeze the window opens again."""
    kw = dict(quant="int8", quant_calib_slices=5, quant_min_foreground=0.0,
              tta=True)
    rng = np.random.default_rng(6)
    batches = [rng.random((2, 16, 16), dtype=np.float32) for _ in range(4)]
    ref_eng, eng = _port(jax_params, **kw), _port(jax_params, **kw)
    ref = [ref_eng.upscale_batch(b) for b in batches]
    routes = []
    gen = eng.upscale_batches(iter(batches))
    for _ in batches:
        routes.append(eng._tta_on_device())
        next(gen)
    assert routes[0] is False and routes[-1] is True
    _same(list(_port(jax_params, **kw).upscale_batches(iter(batches))), ref)
    assert eng._quant_batches == ref_eng._quant_batches


# ---------------------------------------------------------- upscale_tiled


def test_upscale_tiled_matches_jax(jax_params):
    img = np.random.default_rng(7).random((40, 52)).astype(np.float32)
    got = _port(jax_params).upscale_tiled(img, tile=24, halo=4)
    want = _jax(jax_params).upscale_tiled(img, tile=24, halo=4)
    assert got.shape == want.shape == (80, 104)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # a slice that fits one tile is served whole
    small = img[:20, :20]
    np.testing.assert_array_equal(
        _port(jax_params).upscale_tiled(small, tile=24, halo=4),
        _port(jax_params).upscale_image(small))
    with pytest.raises(ValueError, match="per-TILE"):
        _port(jax_params, normalize_inputs=True).upscale_tiled(
            img, tile=24, halo=4)
    with pytest.raises(ValueError, match="must exceed"):
        _port(jax_params).upscale_tiled(img, tile=8, halo=4)


# ------------------------------------------------ InferConfig, load_engine


def test_infer_config_is_the_jax_one():
    got = {f.name: f.default for f in dataclasses.fields(InferConfig)
           if f.name != "model"}
    want = {f.name: f.default for f in dataclasses.fields(JaxInferConfig)
            if f.name != "model"}
    assert got == want
    cfg = InferConfig(batch_size=64, quant_min_foreground=0.1, tta=True,
                      normalize_inputs=True, out_dtype="int16",
                      model=ModelConfig(base_filters=16))
    assert tconfig._build(InferConfig, tconfig.to_dict(cfg)) == cfg


def _jax_checkpoint(d, params):
    jax_ckpt.save_checkpoint(os.path.join(d, "best_model_unet"), params,
                             meta={"config": {"model": {
                                 "model_type": "unet", "base_filters": 16}}})


def test_load_engine_passes_every_field(tmp_path, jax_params):
    _jax_checkpoint(str(tmp_path), jax_params)
    eng = load_engine(InferConfig(checkpoint_dir=str(tmp_path), bf16=False,
                                  quant_min_foreground=0.2,
                                  normalize_inputs=True, transpose_io=True,
                                  out_dtype="uint8"), device="cpu")
    assert (eng.normalize_inputs, eng.transpose_io, eng.out_dtype,
            eng.quant_min_foreground) == (True, True, np.dtype(np.uint8),
                                          0.2)
    assert load_engine(InferConfig(checkpoint_dir=str(tmp_path), tta=True),
                       device="cpu").tta
    with pytest.raises(ValueError, match="must divide the 1 mesh devices"):
        load_engine(InferConfig(checkpoint_dir=str(tmp_path),
                                spatial_shards=2), device="cpu")
    eng = load_engine(InferConfig(checkpoint_dir=str(tmp_path),
                                  spatial_shards=2), device="cpu",
                      devices=[torch.device("cpu")] * 4)
    assert (eng.spatial_shards, eng.n_devices) == (2, 2)


# ----------------------------------------------------- the infer_volume CLI


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_infer_volume", os.path.join(ROOT, "scripts", "infer_volume.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def workspace(tmp_path, jax_params, monkeypatch):
    """A checkpoint both packages read, a 24 x 20 x 6 int16 volume with
    scl_slope 0.5, and the cwd inside tmp_path (the CLIs log there)."""
    monkeypatch.chdir(tmp_path)
    _jax_checkpoint(str(tmp_path), jax_params)
    vol = (np.random.default_rng(8).random((24, 20, 6)) * 1800).astype(
        np.int16)
    jnifti.save(str(tmp_path / "vol.nii.gz"), vol, zooms=(1.2, 1.0, 3.0),
                scl_slope=0.5)
    return tmp_path


def _run_both(ws, monkeypatch, flags, out="sr.nii", inp="vol.nii.gz"):
    common = ["--checkpoint_dir", str(ws), "--cpu", "--no_bf16",
              "--batch_size", "4", *flags]
    rc = cli.main(["--input", str(ws / inp), "--output",
                   str(ws / ("port_" + out)), *common])
    monkeypatch.setattr(sys, "argv", [
        "infer_volume.py", "--input", str(ws / inp), "--output",
        str(ws / ("jax_" + out)), *common])
    jrc = _jax_cli().main()
    return rc, jrc


def _compare(ws, out, int_coded):
    got, ghdr = jnifti.load(str(ws / ("port_" + out)), raw=True)
    want, whdr = nifti.load(str(ws / ("jax_" + out)), raw=True)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert ghdr.zooms == whdr.zooms and ghdr.scl_slope == whdr.scl_slope
    if int_coded:
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return got, ghdr


@pytest.mark.parametrize("flags,int_coded", [
    ([], False),
    (["--serve_raw", "--out_dtype", "int16"], True),
    (["--tta"], False),
    (["--serve_raw", "--tta", "--out_dtype", "uint8"], True)],
    ids=["default", "serve_raw_int16", "tta", "serve_raw_tta_uint8"])
def test_infer_volume_matches_jax(workspace, monkeypatch, flags, int_coded):
    rc, jrc = _run_both(workspace, monkeypatch, flags)
    assert rc == jrc == 0
    got, hdr = _compare(workspace, "sr.nii", int_coded)
    assert got.shape == (48, 40, 6)
    assert hdr.zooms == pytest.approx((0.6, 0.5, 3.0))   # fp32 header
    coded = {"int16": 1 / 32767, "uint8": 1 / 255}
    name = flags[flags.index("--out_dtype") + 1] if int_coded else None
    assert hdr.scl_slope == pytest.approx(coded.get(name, 1.0), rel=1e-6)


def test_infer_volume_writes_the_pngs(workspace, monkeypatch):
    rc = cli.main(["--input", str(workspace / "vol.nii.gz"), "--output",
                   str(workspace / "sr.nii"), "--checkpoint_dir",
                   str(workspace), "--cpu", "--no_bf16", "--serve_raw",
                   "--out_dtype", "int16", "--save_png_dir",
                   str(workspace / "png")])
    assert rc == 0
    sr, _ = nifti.load(str(workspace / "sr.nii"), raw=True)
    from mri_superresolution_torch import native
    for i in (0, 5):
        png = native.imread_gray(str(workspace / "png" /
                                     f"vol.nii_s{i:03d}.png"))
        np.testing.assert_array_equal(
            png, np.round(sr[:, :, i] * (255.0 / 32767.0)).astype(np.uint8))


def test_infer_volume_tiled_matches_jax(workspace, monkeypatch):
    vol = (np.random.default_rng(9).random((40, 52, 2)) * 900).astype(
        np.float32)
    jnifti.save(str(workspace / "big.nii"), vol)
    rc, jrc = _run_both(workspace, monkeypatch, ["--tile", "36"],
                        out="big_sr.nii", inp="big.nii")
    assert rc == jrc == 0
    got, _ = _compare(workspace, "big_sr.nii", False)
    assert got.shape == (80, 104, 2)
    # refused under --serve_raw, as in JAX
    assert cli.main(["--input", str(workspace / "big.nii"), "--output",
                     str(workspace / "x.nii"), "--checkpoint_dir",
                     str(workspace), "--cpu", "--tile", "36",
                     "--serve_raw"]) == 1


def test_infer_volume_directory_batch(workspace, monkeypatch):
    """A directory is served through one engine; a corrupt volume fails
    the run (exit 1) but not the batch."""
    vdir = workspace / "vols"
    vdir.mkdir()
    for name in ("a.nii.gz", "b.nii.gz"):
        (vdir / name).write_bytes((workspace / "vol.nii.gz").read_bytes())
    (vdir / "corrupt.nii").write_bytes(b"not a nifti at all")
    rc, jrc = _run_both(workspace, monkeypatch, [], out="dir", inp="vols")
    assert rc == jrc == 1
    for name in ("a_sr.nii.gz", "b_sr.nii.gz"):
        _compare(workspace, os.path.join("dir", name), False)
    assert not (workspace / "port_dir" / "corrupt_sr.nii").exists()
    (workspace / "empty").mkdir()
    assert cli.main(["--input", str(workspace / "empty"), "--output",
                     str(workspace / "x"), "--checkpoint_dir",
                     str(workspace), "--cpu"]) == 1


@pytest.mark.parametrize("family", ["edsr", "simple"])
def test_infer_volume_serves_other_families_as_jax_does(
        workspace, monkeypatch, family):
    """``--model_type`` picks the family's checkpoint (a JAX-written one,
    base filters 8, edsr 2 blocks) beside the unet's; both CLIs serve it
    to the same volume."""
    from mri_superresolution_tpu.models import build_model as jbuild
    jcfg = JaxModelConfig(model_type=family, base_filters=8, num_blocks=2)
    p = jbuild(jcfg).init(jax.random.key(1), np.zeros((1, 16, 16, 1),
                                                      np.float32))["params"]
    jax_ckpt.save_checkpoint(
        str(workspace / f"best_model_{family}"),
        jax.tree_util.tree_map(np.asarray, p),
        meta={"config": {"model": dataclasses.asdict(jcfg)}})
    rc, jrc = _run_both(workspace, monkeypatch, ["--model_type", family],
                        out=f"{family}.nii")
    assert rc == jrc == 0
    got, _ = _compare(workspace, f"{family}.nii", False)
    assert got.shape == (48, 40, 6)


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


def test_infer_volume_num_devices_matches_jax(workspace, monkeypatch):
    """``--num_devices 8`` on the CPU: each batch of 4 (and the last of
    2) padded to 8 and split over 8 devices, as the JAX CLI's mesh of 8
    host devices does; the volumes within rtol 1e-4, atol 1e-5."""
    rc, jrc = _run_both(workspace, monkeypatch, ["--num_devices", "8"])
    assert rc == jrc == 0
    got, _ = _compare(workspace, "sr.nii", False)
    assert got.shape == (48, 40, 6)


@pytest.mark.parametrize("flags,item", [
    (["--artifact", "m.mrisrx"], "JAX package"),
    (["--num_devices", "3", "--spatial_shards", "2"],
     "spatial_shards=2 must divide the 3 mesh devices")])
def test_infer_volume_refuses_unported_flags(tmp_path, flags, item,
                                             request):
    """``--artifact`` is served since A12, but not a JAX package's
    artifact (jax.export programs): exit 1, naming the package. A
    ``--spatial_shards`` that does not divide the device count exits 1
    with the JAX engine's error."""
    if flags[0] == "--artifact":
        (tmp_path / flags[1]).write_bytes(b"MRISRX1\n" + b"\0" * 16)
        flags = [flags[0], str(tmp_path / flags[1])]
    else:
        ws = request.getfixturevalue("workspace")
        flags = ["--checkpoint_dir", str(ws), *flags]
    argv = ["--input", "v.nii", "--output", str(tmp_path / "o.nii"), "--cpu",
            *flags]
    with _Logs() as logs:
        assert cli.main(argv) == 1
    assert item in logs.text
