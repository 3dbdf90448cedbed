"""The port's quality harnesses beside the JAX package's tools, on the CPU,
at a tiny protocol: ``tools/ema_quality`` (from synthesis on: 2 + 1
volumes, 6 slices each, HR 32^2), ``tools/vgg_quality`` and
``tools/edsr_convergence`` on seeded phantom pairs of 16^2 -> 32^2,
``tools/fetch_vgg_weights --pth`` on a seeded numpy VGG19 state_dict, and
``ema_quality.ema_recompute_gap``."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.models import vgg as jvgg
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_torch import native
from mri_superresolution_torch.models import vgg as tvgg
from mri_superresolution_torch.tools import (edsr_convergence, ema_quality,
                                             fetch_vgg_weights, quality,
                                             vgg_quality)
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import jax_params_from_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")


@pytest.fixture
def package_logger():
    """Restore the port's logger after a test whose CLI set it up."""
    import logging
    logger = logging.getLogger("mri_superresolution_torch")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    yield
    for h in logger.handlers[:]:
        if h not in saved[0]:
            logger.removeHandler(h)
            h.close()
    logger.propagate, logger.level = saved[1], saved[2]


def _jax_tool(name: str, monkeypatch):
    """The JAX package's ``tools/<name>.py`` as a module (its sibling
    imports resolve from ``tools/``)."""
    monkeypatch.syspath_prepend(TOOLS)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_pairs(wd, n_train=10, n_test=4, lr=16):
    """Seeded phantom pairs (LR lr^2, HR (2 lr)^2) as the harnesses' train
    and test splits under ``wd``."""
    for split, n, seed in (("train", n_train, 1), ("test", n_test, 2)):
        hr = phantom_batch(np.random.default_rng(seed), n, 2 * lr)
        lo = phantom_batch(np.random.default_rng(seed), n, lr)
        for d in ("hr", "lr"):
            os.makedirs(os.path.join(wd, f"{d}_{split}"))
        for i in range(n):
            name = f"sub-{i:02d}_T1w_s{i:03d}.png"
            native.imwrite_gray(os.path.join(wd, f"hr_{split}", name),
                                np.round(hr[i] * 255).astype(np.uint8))
            native.imwrite_gray(os.path.join(wd, f"lr_{split}", name),
                                np.round(lo[i] * 255).astype(np.uint8))


def _finite_with_deltas(row):
    for k in quality.METRICS:
        assert np.isfinite(row[k]) and np.isfinite(row[f"delta_{k}"]), k


@pytest.fixture(scope="module")
def ema_run(tmp_path_factory):
    """One tiny ``ema_quality`` run from synthesis on: the control and
    decay 0.9, 2 epochs of the unet each."""
    wd = tmp_path_factory.mktemp("ema")
    report = ema_quality.main([
        "--workdir", str(wd), "--cpu", "--models", "unet", "--decays", "0.9",
        "--epochs", "2", "--n_train_volumes", "2", "--n_test_volumes", "1",
        "--n_slices", "6", "--hr_size", "32", "--batch_size", "4"])
    return wd, report


def test_ema_harness_reports_the_jax_tools_rows(ema_run, package_logger):
    """The report's keys and rows are the JAX tool's, each row finite with
    its deltas; the live weights the EMA run carries (``finalraw``) are
    the control run's final params, bit for bit: EMA never feeds back."""
    wd, report = ema_run
    on_disk = json.load(open(wd / "ema_quality.json"))
    assert list(on_disk) == ["decays", "lr", "epochs", "rows"]
    assert (on_disk["decays"], on_disk["lr"], on_disk["epochs"]) == \
        ([0.9], 1e-4, 2)
    rows = on_disk["rows"]
    assert sorted(rows) == sorted(["unet/best_control", "unet/best_ema0.9",
                                   "unet/final_ema0.9",
                                   "unet/finalraw_ema0.9"])
    for row in rows.values():
        _finite_with_deltas(row)
    assert rows["unet/best_ema0.9"]["delta_vs"] == "unet/best_control"
    assert rows["unet/final_ema0.9"]["delta_vs"] == "unet/finalraw_ema0.9"
    raw = ckpt.load_checkpoint(str(wd / "ckpt_ema0.9" /
                                   "rawfinal_model_unet.ckpt"))[0]
    control = ckpt.load_checkpoint(str(wd / "ckpt_control" /
                                       "final_model_unet.ckpt"))[0]
    assert sorted(raw) == sorted(control)
    assert all(torch.equal(raw[k], control[k]) for k in raw)
    served = ckpt.load_checkpoint(str(wd / "ckpt_ema0.9" /
                                      "final_model_unet.ckpt"))[0]
    assert any(not torch.equal(served[k], raw[k]) for k in raw)


def test_jax_reads_the_ports_ema_checkpoint(ema_run, monkeypatch, tmp_path):
    """The JAX package's ``load_checkpoint`` reads the port's EMA
    checkpoint and its ``raw_params``; the JAX tool's
    ``save_raw_as_params`` on it writes the arrays and meta the port's
    writes."""
    wd, _ = ema_run
    final = str(wd / "ckpt_ema0.9" / "final_model_unet.ckpt")
    params, _, meta, extras = ckpt.load_checkpoint(final, return_extras=True)
    jparams, _, jmeta, jextras = jax_ckpt.load_checkpoint(
        final, return_extras=True)
    assert jmeta == meta
    for got, want in ((jparams, params), (jextras["raw_params"],
                                          extras["raw_params"])):
        want = jax_params_from_state_dict(want)
        flat_g = {"/".join(k): v for k, v in _flat(got)}
        flat_w = {"/".join(k): v for k, v in _flat(want)}
        assert sorted(flat_g) == sorted(flat_w)
        for k, v in flat_w.items():
            np.testing.assert_array_equal(np.asarray(flat_g[k]),
                                          np.asarray(v), err_msg=k)

    tool = _jax_tool("ema_quality", monkeypatch)
    assert tool.save_raw_as_params(final, str(tmp_path / "jax_raw"))
    ema_quality.save_raw_as_params(final, str(tmp_path / "port_raw"))
    a = ckpt.load_checkpoint(str(tmp_path / "jax_raw.ckpt"),
                             return_extras=True)
    b = ckpt.load_checkpoint(str(tmp_path / "port_raw.ckpt"),
                             return_extras=True)
    assert a[2] == b[2] == meta and a[1] is None and b[1] is None
    assert a[3] == b[3] == {}
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(torch.equal(a[0][k], extras["raw_params"][k]) for k in a[0])
    # a checkpoint without raw_params: the JAX tool says False, the port
    # raises
    control = str(wd / "ckpt_control" / "final_model_unet.ckpt")
    assert tool.save_raw_as_params(control, str(tmp_path / "x")) is False
    with pytest.raises(ValueError, match="raw_params"):
        ema_quality.save_raw_as_params(control, str(tmp_path / "y"))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ema_matches_a_float64_recompute(dtype):
    """The trainer's in-place EMA over 4 steps against the float64
    recompute from each step's live weights, within 1e-6 of each tensor's
    largest magnitude (the card's gate, at the CPU's size)."""
    r = ema_quality.ema_recompute_gap("cpu", dtype, steps=4, batch=2,
                                      lr_hw=16, base_filters=16)
    assert r["tensors"] > 0 and r["steps"] == 4
    assert r["worst_rel_gap"] <= 1e-6, r


def test_vgg_harness_reports_every_row(tmp_path, package_logger, capsys):
    """Both loss configurations trained and served in fp32: rows
    ``unet_perc0`` and ``unet_perc0.1`` with their deltas against
    ``unet_perc0``, the delta table; a second run skips training."""
    _write_pairs(str(tmp_path))
    argv = ["--workdir", str(tmp_path), "--cpu", "--epochs", "1",
            "--batch_size", "4", "--hr_size", "32"]
    rows = vgg_quality.main(argv)
    assert list(rows) == ["unet_perc0", "unet_perc0.1"]
    assert json.load(open(tmp_path / "vgg_quality.json")) == rows
    for row in rows.values():
        _finite_with_deltas(row)
        assert row["delta_vs"] == "unet_perc0"
    assert rows["unet_perc0"]["delta_psnr"] == 0.0
    out = capsys.readouterr().out
    assert "pairs already extracted" in out and "| unet | perc0.1 |" in out
    meta = ckpt.read_meta(str(tmp_path / "ckpt_unet_perc0.1" /
                              "best_model_unet.ckpt"))
    assert meta["config"]["loss"]["perceptual_weight"] == 0.1
    again = vgg_quality.main(argv)
    assert "checkpoint exists" in capsys.readouterr().out
    assert again == rows


def test_edsr_convergence_stops_early_under_its_patience(
        tmp_path, package_logger):
    """At learning rate 0 the validation loss never improves after epoch
    0: early stopping ends the run after 1 + patience epochs of the 10;
    the rows ``edsr/plain`` and ``edsr/tta`` (with deltas against plain)
    and the protocol block."""
    _write_pairs(str(tmp_path))
    rows = edsr_convergence.main([
        "--workdir", str(tmp_path), "--cpu", "--epochs", "10",
        "--patience", "2", "--learning_rate", "0", "--batch_size", "4",
        "--hr_size", "32"])
    assert list(rows) == ["edsr/plain", "edsr/tta", "protocol"]
    assert json.load(open(tmp_path / "edsr_convergence.json")) == rows
    for name in ("edsr/plain", "edsr/tta"):
        _finite_with_deltas(rows[name])
        assert rows[name]["delta_vs"] == "edsr/plain"
    assert rows["protocol"] == {"epochs": 10, "patience": 2,
                                "learning_rate": 0.0, "hr_size": 32,
                                "seed": 42}
    lines = [json.loads(ln) for ln in open(tmp_path / "train_edsr.jsonl")
             if ln.startswith("{")]
    epochs = [ln for ln in lines if ln["type"] == "epoch_summary"]
    assert len(epochs) == 3
    assert os.path.exists(tmp_path / "ckpt" / "best_model_edsr.ckpt")


def _vgg19_state_dict(seed: int) -> dict:
    """A torchvision-shaped VGG19 state_dict of seeded numpy weights:
    ``features.*`` convs and the classifier (which the conversion drops)."""
    rng = np.random.default_rng(seed)
    sd, in_ch = {}, 3
    for idx, (kind, arg) in enumerate(tvgg.layer_table()):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                (rng.standard_normal((arg, in_ch, 3, 3))
                 * np.sqrt(2.0 / (9 * in_ch))).astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                (0.01 * rng.standard_normal(arg)).astype(np.float32))
            in_ch = arg
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    return sd


def test_fetch_vgg_weights_converts_a_local_pth(tmp_path, capsys):
    """``--pth``: the ``.npz`` it writes gives the same features through
    the port's ``VGG19Features`` and through the JAX package's
    ``load_params_npz`` + ``extract_features`` (rtol 1e-5)."""
    pth, npz = str(tmp_path / "vgg19.pth"), str(tmp_path / "vgg19.npz")
    torch.save(_vgg19_state_dict(3), pth)
    assert fetch_vgg_weights.main(["--pth", pth, "--out", npz]) == 0
    assert "16 conv layers" in capsys.readouterr().out
    x = np.random.default_rng(4).random((2, 32, 32, 1)).astype(np.float32)
    port = tvgg.VGG19Features.from_params(tvgg.load_params_npz(npz), 35)
    got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jvgg.extract_features(jvgg.load_params_npz(npz),
                                            jnp.asarray(x), 35))
    assert got.shape == want.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_fetch_vgg_weights_without_pth_downloads_nothing(tmp_path, capsys):
    """Without ``--pth`` the conversion exits non-zero, naming
    torchvision's URL, and writes nothing."""
    out = tmp_path / "vgg19.npz"
    assert fetch_vgg_weights.main(["--out", str(out)]) != 0
    assert fetch_vgg_weights.VGG19_URL in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("tool", [ema_quality, vgg_quality, edsr_convergence])
def test_harnesses_want_a_card_without_cpu(tool, tmp_path, monkeypatch):
    """Without ``--cpu`` a harness runs on the card, and raises naming
    ``--cpu`` where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        tool.main(["--workdir", str(tmp_path)])
