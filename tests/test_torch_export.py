"""The port's serving artifacts (``infer/export.py``, ``torch.export``) on
the CPU, case for case with the JAX package's tests/test_export.py: the
artifact against the port's engine on the same weights (fp32 at rtol 1e-5
/ atol 1e-6; the same bits where the program runs the engine's
operations), and against the JAX package's artifact exported from the
same weights (``utils/weights.py``): fp32 at rtol 1e-4, bf16 within 0.1 dB
PSNR of one ground truth, int8 from one set of scales within the int8
budget (CHANGES.md, PR 9: a mean gap under 0.05 and 0.1 dB of one ground
truth), raw int16 within one code. Where a JAX test pins a refusal, the
JAX package refuses beside the port.

Small: the unet at base filters 16, shapes 16^2, 16 x 24 and 12 x 20,
module-scoped artifacts, torch at 2 threads."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.infer.export import (
    export_artifact as jax_export, load_artifact as jax_load)
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer.engine import InferenceEngine
from mri_superresolution_torch.infer.export import (MAGIC, export_artifact,
                                                    load_artifact)
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.ops.metrics import psnr
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(base_filters=16)
JCFG = JaxModelConfig(base_filters=16)


@pytest.fixture(scope="module")
def jax_params():
    params = init_params(JaxUNet(base_filters=16), jax.random.key(0),
                         (16, 16))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def sd(jax_params):
    return state_dict_from_jax(jax_params)


@pytest.fixture(scope="module")
def arts(tmp_path_factory, sd, jax_params):
    """fp32 artifacts of both packages at (16, 16) and (16, 24)."""
    d = tmp_path_factory.mktemp("art")
    port, jx = str(d / "port.mrisrt"), str(d / "jax.mrisrx")
    export_artifact(port, sd, CFG, [(16, 16), (16, 24)], bf16=False)
    jax_export(jx, jax_params, JCFG, [(16, 16), (16, 24)], bf16=False,
               platforms=("cpu",))
    return {"port": port, "jax": jx, "dir": d}


def _engine(sd, **kw):
    return InferenceEngine(CFG, sd, bf16=False, device="cpu", **kw)


def _counts(program) -> dict:
    out = {}
    for n in program.graph.nodes:
        if n.op == "call_function":
            out[str(n.target)] = out.get(str(n.target), 0) + 1
    return out


def _db(a, b) -> float:
    return float(psnr(torch.tensor(np.asarray(a, np.float32)),
                      torch.tensor(np.asarray(b, np.float32))))


def test_artifact_matches_engine(arts, sd):
    """One program per shape serves every batch size (the batch is
    symbolic), within rtol 1e-5 / atol 1e-6 of the engine: on the CPU the
    same bits, since the program runs the engine's operations."""
    art = load_artifact(arts["port"], device="cpu")
    eng = _engine(sd)
    assert art.shapes == [(16, 16), (16, 24)]
    rng = np.random.default_rng(0)
    for shape in ((1, 16, 16), (5, 16, 16), (3, 16, 24)):
        x = rng.random(shape, dtype=np.float32)
        got, want = art.upscale_batch(x), eng.upscale_batch(x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, want)


def test_artifact_matches_jax_artifact(arts):
    """The two packages' fp32 artifacts from the same weights."""
    art = load_artifact(arts["port"], device="cpu")
    jart = jax_load(arts["jax"])
    rng = np.random.default_rng(1)
    for shape in ((2, 16, 16), (3, 16, 24)):
        x = rng.random(shape, dtype=np.float32)
        np.testing.assert_allclose(art.upscale_batch(x),
                                   jart.upscale_batch(x), rtol=1e-4,
                                   atol=1e-5)


def test_bf16_artifact_within_budget_of_jax(arts, sd, jax_params):
    """bf16 artifacts of both packages: within 0.1 dB PSNR of one ground
    truth (bf16 rounds at other places in the two frameworks)."""
    port, jx = str(arts["dir"] / "bf16.mrisrt"), str(arts["dir"] / "bf16.x")
    export_artifact(port, sd, CFG, [(32, 32)], bf16=True)
    jax_export(jx, jax_params, JCFG, [(32, 32)], bf16=True,
               platforms=("cpu",))
    lr = phantom_batch(np.random.default_rng(2), 3, 32)
    hr = phantom_batch(np.random.default_rng(2), 3, 64)
    got = load_artifact(port, device="cpu").upscale_batch(lr)
    want = jax_load(jx).upscale_batch(lr)
    assert abs(_db(got, hr) - _db(want, hr)) <= 0.1
    eng = InferenceEngine(CFG, sd, bf16=True, device="cpu")
    np.testing.assert_array_equal(got, eng.upscale_batch(lr))


def test_artifact_needs_no_model_code(arts):
    """Loading and serving in a fresh process imports none of the model
    zoo, the trainer or the engine (nor JAX)."""
    code = f"""
import sys, numpy as np
from mri_superresolution_torch.infer.export import load_artifact
art = load_artifact({arts['port']!r}, device="cpu")
y = art.upscale_batch(np.random.default_rng(0).random((2, 16, 16),
                                                      dtype=np.float32))
assert y.shape == (2, 32, 32) and np.isfinite(y).all()
bad = [m for m in sys.modules if m.startswith((
    "mri_superresolution_torch.models", "mri_superresolution_torch.train",
    "mri_superresolution_torch.infer.engine", "jax",
    "mri_superresolution_tpu"))]
assert not bad, bad
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


def test_artifact_graph_holds_the_kernels(arts):
    """The program records the port's kernels as operators (B1 20 and B3
    2 a forward), nothing decomposed."""
    art = load_artifact(arts["port"], device="cpu")
    c = _counts(art._programs[(16, 16)])
    assert c["mri_sr.group_norm_leaky.default"] == 20
    assert c["mri_sr.conv3x3.default"] == 2
    assert c["aten.conv2d.default"] == 19


def test_artifact_rejects_unexported_shape(arts):
    art = load_artifact(arts["port"], device="cpu")
    x = np.random.default_rng(0).random((1, 24, 24), dtype=np.float32)
    with pytest.raises(ValueError, match="no program for 24x24"):
        art.upscale_batch(x)
    with pytest.raises(ValueError, match="no program for 24x24"):
        jax_load(arts["jax"]).upscale_batch(x)


def test_artifact_padded_serving(arts):
    """pad=True zero-pads to the smallest fitting exported shape and crops
    the output: a manual pad and an exact-shape call give the same."""
    art = load_artifact(arts["port"], device="cpu")
    x = np.random.default_rng(3).random((2, 8, 20), dtype=np.float32)
    got = art.upscale_batch(x, pad=True)
    assert got.shape == (2, 16, 40)
    padded = np.zeros((2, 16, 24), np.float32)
    padded[:, :8, :20] = x
    np.testing.assert_array_equal(got, art.upscale_batch(padded)[:, :16,
                                                                 :40])
    with pytest.raises(ValueError, match="no exported shape fits"):
        art.upscale_batch(np.zeros((1, 32, 8), np.float32), pad=True)


def test_artifact_upscale_batches_pipelined_equivalence(arts):
    art = load_artifact(arts["port"], device="cpu")
    rng = np.random.default_rng(4)
    batches = [rng.random((2, 16, 16), dtype=np.float32),
               rng.random((3, 8, 20), dtype=np.float32),
               rng.random((1, 16, 24), dtype=np.float32)]
    outs = list(art.upscale_batches(iter(batches), pad=True, depth=2))
    assert len(outs) == 3
    for b, got in zip(batches, outs):
        np.testing.assert_array_equal(got, art.upscale_batch(b, pad=True))


@pytest.fixture(scope="module")
def tta_arts(arts, sd, jax_params):
    port, jx = str(arts["dir"] / "tta.mrisrt"), str(arts["dir"] / "tta.x")
    export_artifact(port, sd, CFG, [(16, 16), (12, 20)], bf16=False,
                    mode="tta")
    jax_export(jx, jax_params, JCFG, [(12, 20)], bf16=False,
               platforms=("cpu",), mode="tta")
    return load_artifact(port, device="cpu"), jax_load(jx)


def test_artifact_tta_mode(tta_arts, sd):
    """The whole dihedral ensemble in one program (8 members square, 4
    otherwise, each padded to %8 after its transform): the engine's
    on-device TTA at a square %8 shape, and the JAX artifact at a
    non-square one that is not %8."""
    art, jart = tta_arts
    assert art.mode == "tta"
    rng = np.random.default_rng(5)
    x = rng.random((2, 16, 16), dtype=np.float32)
    np.testing.assert_array_equal(art.upscale_batch(x),
                                  _engine(sd, tta=True).upscale_batch(x))
    x = rng.random((2, 12, 20), dtype=np.float32)
    np.testing.assert_allclose(art.upscale_batch(x), jart.upscale_batch(x),
                               rtol=1e-4, atol=1e-5)
    c = _counts(art._programs[(16, 16)])
    assert c["mri_sr.group_norm_leaky.default"] == 8 * 20
    assert c["aten.flip.default"] >= 6


def test_artifact_tta_mode_refuses_padding(tta_arts):
    art, jart = tta_arts
    x = np.zeros((1, 8, 16), np.float32)
    for a in (art, jart):
        with pytest.raises(ValueError, match="tta-mode artifact cannot"):
            a.upscale_batch(x, pad=True)


def test_artifact_tta_packed_output(arts, sd, tta_arts):
    """tta with out_dtype uint8 packs the fp32 mean (the engine's order)."""
    path = str(arts["dir"] / "tta8.mrisrt")
    export_artifact(path, sd, CFG, [(12, 20)], bf16=False, mode="tta",
                    out_dtype="uint8")
    x = np.random.default_rng(6).random((2, 12, 20), dtype=np.float32)
    got = load_artifact(path, device="cpu").upscale_batch(x)
    assert got.dtype == np.uint8
    want = np.round(np.clip(tta_arts[0].upscale_batch(x), 0, 1) * 255.0)
    np.testing.assert_array_equal(got, want.astype(np.uint8))


def test_artifact_int8_mode(arts, sd, jax_params):
    """The frozen-scale int8 forward and a plain fallback a shape: a
    content-rich batch matches the port's int8 engine on the same scales
    and the JAX int8 artifact within the int8 budget; a near-empty one
    serves the fallback, as the engine routes it; scales are required."""
    lr = phantom_batch(np.random.default_rng(7), 3, 16)
    hr = phantom_batch(np.random.default_rng(7), 3, 32)
    scales = jqf.calibrate(jax_params, [lr[..., None]], "unet",
                           dtype=jnp.float32)
    port, jx = str(arts["dir"] / "i8.mrisrt"), str(arts["dir"] / "i8.x")
    export_artifact(port, sd, CFG, [(16, 16)], bf16=False, mode="int8",
                    quant_scales=scales)
    jax_export(jx, jax_params, JCFG, [(16, 16)], bf16=False,
               platforms=("cpu",), mode="int8", quant_scales=scales)
    art, jart = load_artifact(port, device="cpu"), jax_load(jx)
    assert art.mode == "int8" and art.routed and jart.routed
    calib = str(arts["dir"] / "i8.calib.json")
    qf.save_scales(calib, scales, "unet")
    eng = _engine(sd, quant="int8", quant_calib_path=calib)
    got = art.upscale_batch(lr)
    np.testing.assert_allclose(got, eng.upscale_batch(lr), rtol=1e-5,
                               atol=1e-6)
    want = jart.upscale_batch(lr)
    assert np.abs(got - want).mean() < 0.05
    assert abs(_db(got, hr) - _db(want, hr)) <= 0.1
    empty = np.zeros((2, 16, 16), np.float32)
    empty[:, :2, :2] = 0.5
    plain = load_artifact(arts["port"], device="cpu")
    np.testing.assert_array_equal(art.upscale_batch(empty),
                                  plain.upscale_batch(empty))
    np.testing.assert_array_equal(art.upscale_batch(empty),
                                  eng.upscale_batch(empty))
    assert eng._quant_batches == {"int8": 1, "bf16": 1}
    c = _counts(art._programs[(16, 16)])
    assert c["mri_sr.gn_quantize.default"] == 7
    assert c["mri_sr.leaky_quantize.default"] == 13
    assert c["mri_sr.group_norm_leaky.default"] == 13
    assert c["aten._int_mm.default"] == 20
    for exp in (export_artifact, jax_export):
        w = sd if exp is export_artifact else jax_params
        cfg = CFG if exp is export_artifact else JCFG
        with pytest.raises(ValueError, match="requires quant_scales"):
            exp(str(arts["dir"] / "no"), w, cfg, [(16, 16)], bf16=False,
                mode="int8")


def test_artifact_packed_output(arts, sd):
    """out_dtype int16 packs on the device: the engine's packed output."""
    path = str(arts["dir"] / "i16.mrisrt")
    export_artifact(path, sd, CFG, [(16, 16)], bf16=False,
                    out_dtype="int16")
    art = load_artifact(path, device="cpu")
    assert art.out_dtype == np.dtype(np.int16)
    x = np.random.default_rng(8).random((3, 16, 16), dtype=np.float32)
    got = art.upscale_batch(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(
        got, _engine(sd, out_dtype=np.int16).upscale_batch(x))


def test_artifact_serve_raw_matches_raw_engine(arts, sd, jax_params):
    """serve_raw: raw int16 batches in the transposed layout through the
    program, the raw engine's bits; the JAX raw artifact within a code."""
    port, jx = str(arts["dir"] / "raw.mrisrt"), str(arts["dir"] / "raw.x")
    export_artifact(port, sd, CFG, [(16, 24)], bf16=False, serve_raw=True,
                    raw_dtype="int16", out_dtype="int16")
    jax_export(jx, jax_params, JCFG, [(16, 24)], bf16=False,
               platforms=("cpu",), serve_raw=True, raw_dtype="int16",
               out_dtype="int16")
    art = load_artifact(port, device="cpu")
    assert art.normalize_inputs and art.transpose_io
    assert art.raw_dtype == np.dtype(np.int16)
    batch = (np.random.default_rng(9).random((2, 24, 16)) * 900).astype(
        np.int16)
    got = art.upscale_batch(batch)
    assert got.shape == (2, 48, 32) and got.dtype == np.int16
    eng = _engine(sd, normalize_inputs=True, transpose_io=True,
                  out_dtype=np.int16)
    np.testing.assert_array_equal(got, eng.upscale_batch(batch))
    # one code, the packages' cross-check of int16 volumes
    # (tests/test_torch_volume.py)
    d = np.abs(got.astype(np.int32)
               - jax_load(jx).upscale_batch(batch).astype(np.int32))
    assert d.max() <= 1
    assert _counts(art._programs[(16, 24)])["aten.sort.default"] >= 1


def test_artifact_serve_raw_validation(arts, sd, jax_params):
    d = arts["dir"]
    for exp, w, cfg in ((export_artifact, sd, CFG),
                        (jax_export, jax_params, JCFG)):
        kw = {} if exp is export_artifact else {"platforms": ("cpu",)}
        with pytest.raises(ValueError, match="plain"):
            exp(str(d / "v"), w, cfg, [(16, 16)], bf16=False, mode="tta",
                serve_raw=True, **kw)
        with pytest.raises(ValueError, match="int8"):
            exp(str(d / "v"), w, cfg, [(16, 16)], bf16=False, mode="int8",
                out_dtype="int16", **kw)
    path = str(d / "rawu16.mrisrt")
    export_artifact(path, sd, CFG, [(16, 16)], bf16=False, serve_raw=True,
                    raw_dtype="uint16")
    art = load_artifact(path, device="cpu")
    with pytest.raises(ValueError, match="uint16"):
        art.upscale_batch(np.zeros((1, 16, 16), np.float32))
    with pytest.raises(ValueError, match="pad"):
        art.upscale_batch(np.zeros((1, 24, 24), np.uint16), pad=True)
    with pytest.raises(ValueError, match="single-image"):
        art.process_single_image("x.png", "y.png")


def test_artifact_refusals(arts, sd, jax_params, tmp_path):
    """Garbage, a JAX artifact, an unknown format, a platform the
    artifact does not promise; at export, non-%8 shapes, spatial
    artifacts (ROADMAP A14), an unknown mode or dtype or platform."""
    bad = str(tmp_path / "bad.mrisrt")
    open(bad, "wb").write(b"not an artifact")
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_artifact(bad, device="cpu")
    with pytest.raises(ValueError, match="not a serving artifact"):
        jax_load(bad)
    with pytest.raises(ValueError, match="JAX package"):
        load_artifact(arts["jax"], device="cpu")
    with open(arts["port"], "rb") as f:
        blob = f.read()
    hdr_len = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 4], "little")
    hdr = blob[len(MAGIC) + 4:len(MAGIC) + 4 + hdr_len]
    other = str(tmp_path / "other.mrisrt")
    for old, new in ((b"torch-serving-artifact-v1",
                      b"torch-serving-artifact-v9"),
                     (b'"platforms": ["cuda", "cpu"]',
                      b'"platforms": ["cuda"]       ')):
        h2 = hdr.replace(old, new)
        assert len(h2) == len(hdr) and h2 != hdr
        open(other, "wb").write(blob.replace(hdr, h2))
        with pytest.raises(ValueError, match="unknown artifact format|"
                                             "exported for"):
            load_artifact(other, device="cpu")
    with pytest.raises(ValueError, match="%8"):
        export_artifact(str(tmp_path / "x"), sd, CFG, [(10, 16)],
                        bf16=False)
    with pytest.raises(ValueError, match="%8"):
        jax_export(str(tmp_path / "x"), jax_params, JCFG, [(10, 16)],
                   bf16=False, platforms=("cpu",))
    with pytest.raises(NotImplementedError, match="A14"):
        export_artifact(str(tmp_path / "x"), sd, CFG, [(32, 32)],
                        spatial_shards=4)
    for kw, match in (({"mode": "fancy"}, "unknown artifact mode"),
                      ({"out_dtype": "float16"}, "out_dtype"),
                      ({"serve_raw": True, "raw_dtype": "int8"},
                       "raw_dtype"),
                      ({"platforms": ("tpu",)}, "platforms")):
        with pytest.raises(ValueError, match=match):
            export_artifact(str(tmp_path / "x"), sd, CFG, [(16, 16)], **kw)
    assert not os.path.exists(str(tmp_path / "x"))


def test_artifact_header(arts):
    """The container: the port's magic, a JSON header with the JAX
    header's keys plus torch_version, then length-prefixed programs."""
    import json
    with open(arts["port"], "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC
        n = int.from_bytes(f.read(4), "little")
        header = json.loads(f.read(n))
    for key in ("format", "model_type", "base_filters", "bf16", "scale",
                "mode", "platforms", "shapes", "routed", "min_foreground",
                "serve_raw", "raw_dtype", "out_dtype", "torch_version"):
        assert key in header, key
    assert header["platforms"] == ["cuda", "cpu"]
    assert header["shapes"] == [[16, 16], [16, 24]]
    assert header["torch_version"] == torch.__version__


def test_artifact_single_image_pipeline(arts, tmp_path):
    """The engine's single-image pipeline (normalize, histogram matching,
    metrics, PNG) runs off the artifact's forward."""
    cv2 = pytest.importorskip("cv2")
    art = load_artifact(arts["port"], device="cpu")
    rng = np.random.default_rng(10)
    ip, tp = str(tmp_path / "in.png"), str(tmp_path / "tgt.png")
    cv2.imwrite(ip, rng.integers(0, 255, (16, 16), dtype=np.uint8))
    cv2.imwrite(tp, rng.integers(0, 255, (32, 32), dtype=np.uint8))
    out, metrics = art.process_single_image(ip, str(tmp_path / "o.png"), tp)
    assert out.shape == (32, 32)
    assert metrics and "ssim" in metrics
