"""The port's export CLI (``cli/export_serving.py``) and ``--artifact`` in
``cli.infer``, ``cli.infer_volume`` and ``cli.serve`` on the CPU, each
beside the JAX package's script on the same artifact mode: the output
line, the int8 sidecar's resolution, the policy for the other flags (a
mode the artifact exports is satisfied, one it cannot serve exits 1,
``--bucket`` and ``--num_devices`` are named as ignored) and its exit
codes, and the daemon's batcher padding slices for an artifact backend.
Volumes served from an artifact are held voxel for voxel to the same CLI
from the checkpoint (fp32 on the CPU: the same operations)."""

import importlib.util
import io
import json
import logging
import os
import re
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu import nifti as jnifti
from mri_superresolution_tpu.infer.export import (
    export_artifact as jax_export, load_artifact as jax_load)
from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_torch.cli import export_serving as export_cli
from mri_superresolution_torch.cli import infer as infer_cli
from mri_superresolution_torch.cli import infer_volume as volume_cli
from mri_superresolution_torch.cli import serve as serve_cli
from mri_superresolution_torch.infer.export import load_artifact
from mri_superresolution_torch.infer.server import DynamicBatcher

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JaxModelConfig(base_filters=16)
VOL_HW = (24, 16)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, *name.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(monkeypatch, script, argv):
    monkeypatch.setattr(sys, "argv", [script, *argv])
    return _script(script).main()


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


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A JAX checkpoint both packages read, its QAT-style sidecar, a PNG
    pair, a 24 x 16 x 5 int16 volume, and the artifacts of both packages
    (plain fp32 at 16^2 and 24 x 16; tta, int8 and raw int16 at 24 x
    16)."""
    d = tmp_path_factory.mktemp("cli")
    params = jax.tree_util.tree_map(np.asarray, init_params(
        JaxUNet(base_filters=16), jax.random.key(0), (16, 16)))
    base = str(d / "best_model_unet")
    jax_ckpt.save_checkpoint(base, params, meta={"config": {"model": {
        "model_type": "unet", "base_filters": 16}}})
    rng = np.random.default_rng(0)
    lr = rng.random((2, 16, 16, 1), dtype=np.float32)
    scales = jqf.calibrate(params, [lr], "unet", dtype=jnp.float32)
    jqf.save_scales(base + ".calib.json", scales, "unet")
    cv2 = pytest.importorskip("cv2")
    cv2.imwrite(str(d / "in.png"), rng.integers(0, 255, VOL_HW,
                                                dtype=np.uint8))
    vol = (rng.random(VOL_HW + (5,)) * 900).astype(np.int16)
    jnifti.save(str(d / "vol.nii.gz"), vol, zooms=(1.0, 1.0, 2.0),
                scl_slope=0.5)
    out = {"dir": d, "params": params, "scales": scales}
    cwd = os.getcwd()
    os.chdir(d)        # the CLIs write their logs to the cwd
    try:
        for mode, flags in (
                ("plain", ["--shapes", "16x16,24x16"]),
                ("tta", ["--shapes", "24x16", "--mode", "tta"]),
                ("int8", ["--shapes", "24x16", "--mode", "int8"]),
                ("raw", ["--shapes", "24x16", "--serve_raw",
                         "--out_dtype", "int16"])):
            path = str(d / f"{mode}.mrisrt")
            assert export_cli.main(["--checkpoint_dir", str(d), "--out",
                                    path, "--base_filters", "16", "--cpu",
                                    "--no_bf16", *flags]) == 0
            out[mode] = path
    finally:
        os.chdir(cwd)
    shapes = {"plain": [(16, 16), VOL_HW], "tta": [VOL_HW],
              "int8": [VOL_HW], "raw": [VOL_HW]}
    for mode, kw in (("plain", {}), ("tta", {"mode": "tta"}),
                     ("int8", {"mode": "int8", "quant_scales": scales}),
                     ("raw", {"serve_raw": True, "out_dtype": "int16"})):
        path = str(d / f"{mode}.mrisrx")
        jax_export(path, params, JCFG, shapes[mode], bf16=False,
                   platforms=("cpu",), **kw)
        out["jax_" + mode] = path
    return out


_LINE = re.compile(r"^Wrote (\S+) \((\d+\.\d) MiB\): unet bf=16 mode=plain "
                   r"shapes=\[\(16, 16\)\] platforms=(\S+) \(batch "
                   r"symbolic\)$", re.M)


def test_export_cli_prints_the_jax_tools_line(ws, monkeypatch, capsys):
    d = ws["dir"]
    monkeypatch.chdir(d)
    port, jx = str(d / "line.mrisrt"), str(d / "line.mrisrx")
    assert export_cli.main(["--checkpoint_dir", str(d), "--out", port,
                            "--shapes", "16x16", "--base_filters", "16",
                            "--cpu", "--no_bf16"]) == 0
    got = _LINE.search(capsys.readouterr().out)
    assert got and got.group(1) == port and got.group(3) == "cuda,cpu"
    assert float(got.group(2)) == pytest.approx(
        os.path.getsize(port) / 2**20, abs=0.05)
    _jax_main(monkeypatch, "tools/export_serving.py", [
        "--checkpoint_dir", str(d), "--out", jx, "--shapes", "16x16",
        "--base_filters", "16", "--cpu", "--no_bf16", "--platforms", "cpu"])
    want = _LINE.search(capsys.readouterr().out)
    assert want and want.group(3) == "cpu"
    x = np.random.default_rng(1).random((2, 16, 16), dtype=np.float32)
    np.testing.assert_allclose(load_artifact(port, "cpu").upscale_batch(x),
                               jax_load(jx).upscale_batch(x), rtol=1e-4,
                               atol=1e-5)


def test_export_cli_int8_sidecar_resolution(ws, monkeypatch, capsys,
                                            tmp_path):
    """int8 reads the sidecar next to the resolved checkpoint, as the JAX
    tool does, or ``--quant_calib``; a missing sidecar or one of another
    model type exits 1."""
    d = ws["dir"]
    monkeypatch.chdir(tmp_path)
    common = ["--checkpoint_dir", str(d), "--shapes", "16x16",
              "--base_filters", "16", "--cpu", "--no_bf16", "--mode", "int8"]
    side = os.path.join(str(d), "best_model_unet.calib.json")
    assert export_cli.main(common + ["--out", str(tmp_path / "a")]) == 0
    assert f"int8 mode: 20 frozen scales from {side}" in \
        capsys.readouterr().out
    _jax_main(monkeypatch, "tools/export_serving.py", common + [
        "--out", str(tmp_path / "b"), "--platforms", "cpu"])
    assert f"int8 mode: 20 frozen scales from {side}" in \
        capsys.readouterr().out
    other = str(tmp_path / "other.json")
    jqf.save_scales(other, ws["scales"], "unet")
    assert export_cli.main(common + ["--out", str(tmp_path / "c"),
                                     "--quant_calib", other]) == 0
    assert f"from {other}" in capsys.readouterr().out
    jqf.save_scales(other, ws["scales"], "unet_tpu")
    assert export_cli.main(common + ["--out", str(tmp_path / "d"),
                                     "--quant_calib", other]) == 1
    assert export_cli.main(common + ["--out", str(tmp_path / "e"),
                                     "--quant_calib",
                                     str(tmp_path / "none.json")]) == 1
    assert not os.path.exists(str(tmp_path / "e"))


@pytest.mark.parametrize("flag,word", [
    (["--spatial_shards", "2"], "must divide the 1 export devices"),
    (["--spatial_shards", "2", "--spatial_devices", "2", "--serve_raw"],
     "serve_raw does not compose with spatial artifacts")])
def test_export_cli_refuses_spatial(ws, flag, word, tmp_path, monkeypatch):
    """Spatial exports the JAX CLI refuses too: a shard count that does
    not divide the export devices (one with ``--cpu`` unless
    ``--spatial_devices`` names more), and ``--serve_raw``."""
    monkeypatch.chdir(tmp_path)
    with _Logs() as logs:
        assert export_cli.main(["--checkpoint_dir", str(ws["dir"]), "--out",
                                str(tmp_path / "s"), "--cpu", *flag]) == 1
    assert word in logs.text
    assert not os.path.exists(str(tmp_path / "s"))


@pytest.mark.parametrize("mode,flags,ignored", [
    ("plain", [], None), ("tta", ["--tta"], None),
    ("int8", ["--quant", "int8"], None),
    ("plain", ["--tta", "--bucket", "8"], "--tta, --bucket")])
def test_infer_cli_serves_an_artifact(ws, monkeypatch, tmp_path, mode, flags,
                                      ignored):
    """Exit 0 and a 2x PNG from the artifact, a mode it exports satisfied
    and one it does not named as ignored, as the JAX script does with its
    own artifact (the PNGs within one code)."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.chdir(tmp_path)
    common = ["--input", str(ws["dir"] / "in.png"), "--cpu", *flags]
    with _Logs() as logs:
        assert infer_cli.main(common + ["--artifact", ws[mode], "--output",
                                        "port.png"]) == 0
    assert "Serving from artifact" in logs.text
    if ignored:
        assert f"{ignored} are IGNORED" in logs.text
    else:
        assert "IGNORED" not in logs.text
    assert _jax_main(monkeypatch, "scripts/infer.py", common + [
        "--artifact", ws["jax_" + mode], "--output", "jax.png"]) == 0
    got = cv2.imread("port.png", cv2.IMREAD_GRAYSCALE)
    want = cv2.imread("jax.png", cv2.IMREAD_GRAYSCALE)
    assert got.shape == want.shape == (48, 32)
    d = np.abs(got.astype(int) - want.astype(int))
    if mode == "int8":      # the int8 budget: a mean gap under 0.05
        assert d.mean() < 0.05 * 255
    else:
        assert d.max() <= 1


def _volume(path):
    from mri_superresolution_torch import nifti
    return nifti.load(path, raw=True)


@pytest.mark.parametrize("mode,flags,vol_hw", [
    ("plain", [], VOL_HW), ("plain", [], (20, 12)),
    ("raw", ["--serve_raw", "--out_dtype", "int16"], VOL_HW),
    ("raw", [], VOL_HW), ("tta", ["--tta"], VOL_HW)],
    ids=["plain", "plain_padded", "raw_satisfied", "raw", "tta"])
def test_infer_volume_cli_serves_an_artifact(ws, monkeypatch, tmp_path, mode,
                                             flags, vol_hw):
    """The volume through the artifact, voxel for voxel the same CLI from
    the checkpoint (a padded shape: the checkpoint at that bucket); the
    JAX script serves its own artifact the same way (exit 0, the same
    shape, dtype and slope)."""
    monkeypatch.chdir(tmp_path)
    vol = (np.random.default_rng(2).random(vol_hw + (5,)) * 900).astype(
        np.int16)
    jnifti.save("v.nii", vol, zooms=(1.0, 1.0, 2.0), scl_slope=0.5)
    common = ["--input", "v.nii", "--cpu", "--batch_size", "2", *flags]
    assert volume_cli.main(common + ["--artifact", ws[mode],
                                     "--output", "art.nii"]) == 0
    ck = ["--checkpoint_dir", str(ws["dir"]), "--no_bf16"]
    if mode == "raw":
        ck += ["--serve_raw", "--out_dtype", "int16"]
    if vol_hw != VOL_HW and mode == "plain":
        ck += ["--bucket", "8"]
    if mode == "tta":
        ck += ["--tta"] if "--tta" not in flags else []
    drop = {"--serve_raw", "--out_dtype", "int16"} if mode == "raw" else \
        set()
    assert volume_cli.main([a for a in common if a not in drop] + ck + [
        "--output", "ck.nii"]) == 0
    got, ghdr = _volume("art.nii")
    want, whdr = _volume("ck.nii")
    assert got.shape == (2 * vol_hw[0], 2 * vol_hw[1], 5)
    assert got.dtype == want.dtype and ghdr.scl_slope == whdr.scl_slope
    np.testing.assert_array_equal(got, want)
    assert _jax_main(monkeypatch, "scripts/infer_volume.py", common + [
        "--artifact", ws["jax_" + mode], "--output", "jax.nii"]) == 0
    jgot, jhdr = jnifti.load("jax.nii", raw=True)
    assert jgot.shape == got.shape and jgot.dtype == got.dtype
    assert jhdr.scl_slope == pytest.approx(ghdr.scl_slope)


@pytest.mark.parametrize("mode,flags,vol_hw,word", [
    ("plain", ["--quant", "int8"], VOL_HW, "--quant"),
    ("plain", ["--tta"], VOL_HW, "--tta"),
    ("plain", ["--serve_raw"], VOL_HW, "--serve_raw"),
    ("plain", ["--out_dtype", "int16"], VOL_HW, "--out_dtype"),
    ("plain", ["--spatial_shards", "2"], VOL_HW, "--spatial_shards"),
    ("raw", [], (16, 16), "serve_raw artifact has no program"),
    ("tta", ["--tta"], (16, 16), "tta-mode artifact has no program")],
    ids=["quant", "tta", "serve_raw", "out_dtype", "spatial", "raw_shape",
         "tta_shape"])
def test_infer_volume_cli_refuses_what_the_artifact_cannot_serve(
        ws, monkeypatch, tmp_path, mode, flags, vol_hw, word):
    """Exit 1 with the JAX error's meaning; the JAX script refuses its own
    artifact of the same mode with the same flags."""
    monkeypatch.chdir(tmp_path)
    vol = (np.random.default_rng(3).random(vol_hw + (3,)) * 900).astype(
        np.int16)
    jnifti.save("v.nii", vol, zooms=(1.0, 1.0, 2.0))
    common = ["--input", "v.nii", "--output", "o.nii", "--cpu", *flags]
    with _Logs() as logs:
        assert volume_cli.main(common + ["--artifact", ws[mode]]) == 1
    assert word in logs.text
    assert _jax_main(monkeypatch, "scripts/infer_volume.py", common + [
        "--artifact", ws["jax_" + mode]]) == 1


def test_infer_volume_cli_names_ignored_flags(ws, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    jnifti.save("v.nii", np.ones(VOL_HW + (2,), np.int16),
                zooms=(1.0, 1.0, 2.0))
    with _Logs() as logs:
        assert volume_cli.main(["--input", "v.nii", "--output", "o.nii",
                                "--cpu", "--artifact", ws["plain"],
                                "--bucket", "8", "--num_devices",
                                "2"]) == 0
    assert "--bucket, --num_devices are IGNORED" in logs.text


@pytest.mark.parametrize("mode,flags", [
    ("plain", ["--quant", "int8"]), ("plain", ["--tta"]),
    ("plain", ["--serve_raw"]), ("plain", ["--out_dtype", "uint8"]),
    ("plain", ["--num_devices", "2"]), ("plain", ["--spatial_shards", "2"]),
    ("raw", ["--out_dtype", "uint8"])],
    ids=["quant", "tta", "serve_raw", "out_dtype", "num_devices", "spatial",
         "raw_out_dtype"])
def test_serve_cli_refuses_what_the_artifact_cannot_serve(
        ws, monkeypatch, tmp_path, mode, flags):
    """Exit 1 before any server starts, as the JAX script does with its
    own artifact of the same mode."""
    monkeypatch.chdir(tmp_path)
    argv = ["--cpu", "--port", "0", *flags]
    with _Logs() as logs:
        assert serve_cli.main(argv + ["--artifact", ws[mode]]) == 1
    assert "--artifact is incompatible with" in logs.text
    assert _jax_main(monkeypatch, "scripts/serve.py", argv + [
        "--artifact", ws["jax_" + mode]]) == 1


def test_serve_cli_serves_an_artifact(ws, tmp_path):
    """The daemon on an artifact in a process of its own, flags it exports
    satisfied and --bucket ignored: /healthz describes the artifact, and
    /upscale of a stack of two slices (one of a shape it pads) gives the
    artifact's own ``upscale_batch``."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mri_superresolution_torch.cli.serve",
         "--artifact", ws["int8"], "--quant", "int8", "--bucket", "8",
         "--port", str(port), "--cpu"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()[1][-2000:]
                assert time.monotonic() < deadline
                time.sleep(0.5)
        assert health["artifact"]["mode"] == "int8"
        assert health["artifact"]["shapes"] == [list(VOL_HW)]
        assert "artifact int8.mrisrt unet mode=int8" in health["backend"]
        x = np.random.default_rng(4).random((2,) + VOL_HW, dtype=np.float32)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(base + "/upscale", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))
        art = load_artifact(ws["int8"], device="cpu")
        np.testing.assert_array_equal(got, art.upscale_batch(x))
        one = x[0, :12, :8]
        buf = io.BytesIO()
        np.save(buf, one)
        req = urllib.request.Request(base + "/upscale", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))
        np.testing.assert_array_equal(got, art.upscale_batch(
            one[None], pad=True)[0])
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "--bucket is IGNORED" in err


def test_batcher_pads_slices_for_an_artifact_backend(ws):
    """A backend whose ``upscale_batch`` takes ``pad`` gets ``pad=True``
    (a slice of an unexported shape is served padded, as the JAX batcher
    does) and its groups go at their own size, not a power of two."""
    art = load_artifact(ws["plain"], device="cpu")
    b = DynamicBatcher(art, max_batch=8, batch_window_ms=200.0)
    try:
        batch = np.random.default_rng(5).random((3, 12, 10),
                                                dtype=np.float32)
        reqs = [b.submit(s) for s in batch]
        outs = np.stack([b.wait(r, timeout=120) for r in reqs])
        np.testing.assert_array_equal(outs, art.upscale_batch(batch,
                                                              pad=True))
        assert outs.shape == (3, 24, 20)
        assert dict(b.batch_size_hist) == {3: 1}
    finally:
        b.close()
