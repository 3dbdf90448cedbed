"""The port's evaluation CLI (``cli/evaluate.py``) and resolution
analytics (``evalsuite/resolution.py``) against the JAX package's
``evaluate.py`` and ``evalsuite/resolution.py`` on the CPU: 6 phantom
pairs (LR 16² → HR 32²) and a unet of base filters 16 whose JAX weights
both packages load from one ``.ckpt``."""

import csv
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import evaluate as jeval
from mri_superresolution_tpu.config import InferConfig as JaxInferConfig
from mri_superresolution_tpu.evalsuite import resolution as jres
from mri_superresolution_tpu.infer import load_engine as jax_load_engine
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_torch import native
from mri_superresolution_torch.cli import evaluate as tev
from mri_superresolution_torch.config import (InferConfig, ModelConfig,
                                              TrainConfig, to_dict)
from mri_superresolution_torch.evalsuite import resolution as tres
from mri_superresolution_torch.infer import load_engine
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.tools import export_torch_checkpoint
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

N_PAIRS = 6
METHODS = ("bicubic", "bilinear", "sharp_bilinear", "unet")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """hr/ and lr/ PNG pairs of 3 subjects and ckpt/best_model_unet.ckpt
    (JAX's initial unet at base filters 16, fusion weight 25%, with a
    sidecar of hyperparameters and validation results)."""
    ws = tmp_path_factory.mktemp("eval_ws")
    hr = phantom_batch(np.random.default_rng(1), N_PAIRS, 32)
    lr = phantom_batch(np.random.default_rng(2), N_PAIRS, 16)
    for sub in ("hr", "lr", "ckpt"):
        (ws / sub).mkdir()
    for i in range(N_PAIRS):
        name = f"sub-{i // 2:02d}_T1w_s{i:03d}.png"
        native.imwrite_gray(str(ws / "hr" / name),
                            np.round(hr[i] * 255).astype(np.uint8))
        native.imwrite_gray(str(ws / "lr" / name),
                            np.round(lr[i] * 255).astype(np.uint8))
    params = jax.tree_util.tree_map(np.asarray, init_params(
        JaxUNet(base_filters=16, initial_alpha=25.0), jax.random.key(0),
        (16, 16)))
    cfg = TrainConfig(model=ModelConfig(base_filters=16, initial_alpha=25.0),
                      epochs=3, batch_size=4)
    ckpt.save_checkpoint(str(ws / "ckpt" / "best_model_unet"),
                         state_dict_from_jax(params),
                         meta={"config": to_dict(cfg), "epoch": 2,
                               "val_loss": 0.125, "val_ssim": 0.75})
    return ws


def _pairs(ws):
    return tev._pairs(str(ws / "hr"), str(ws / "lr"))


def _ckpt(ws):
    return str(ws / "ckpt" / "best_model_unet.ckpt")


def _by_key(rows):
    return {(r["image"], r["method"]): r for r in rows}


@pytest.mark.parametrize("bf16", [False, True])
def test_run_benchmarks_matches_jax(workspace, bf16):
    """Per image and method, the port's metrics against JAX's
    ``run_benchmarks`` on the same pairs and weights: the baselines within
    1e-5; the unet in fp32 within rtol 1e-4, in bf16 within 0.1 dB PSNR
    and 1e-3 SSIM. The same rows in the same order, each with a time."""
    pairs = _pairs(workspace)
    jeng = jax_load_engine(JaxInferConfig(checkpoint_path=_ckpt(workspace),
                                          bf16=bf16))
    want = jeval.run_benchmarks(pairs, jeng).to_dict("records")
    eng = load_engine(InferConfig(checkpoint_path=_ckpt(workspace),
                                  bf16=bf16), device="cpu")
    got = tev.run_benchmarks(pairs, eng)
    assert [(r["image"], r["method"]) for r in got] == \
        [(r["image"], r["method"]) for r in want]
    assert len(got) == 4 * N_PAIRS
    assert [list(r) for r in got] == [list(r) for r in want]
    for key, w in _by_key(want).items():
        g = _by_key(got)[key]
        assert g["time"] > 0
        if key[1] != "unet":
            for m in ("ssim", "psnr", "mse", "rmse", "mae"):
                assert abs(g[m] - w[m]) <= 1e-5, (key, m, g[m], w[m])
        elif not bf16:
            for m in ("ssim", "psnr", "mse", "rmse", "mae"):
                np.testing.assert_allclose(g[m], w[m], rtol=1e-4,
                                           err_msg=str((key, m)))
        else:
            assert abs(g["psnr"] - w["psnr"]) <= 0.1, key
            assert abs(g["ssim"] - w["ssim"]) <= 1e-3, key


def test_evaluate_checkpoint_csv_columns_match_jax(workspace, tmp_path,
                                                   monkeypatch):
    """The metrics CSV of one checkpoint: JAX's pandas table and the
    port's ``csv`` rows have the same columns in the same order, the same
    row count, and the checkpoint's label and details in every row."""
    monkeypatch.chdir(tmp_path)
    pairs = _pairs(workspace)
    df, jimpl = jeval._evaluate_checkpoint(_ckpt(workspace), pairs,
                                           str(tmp_path / "j"), 16, "best")
    df.to_csv(tmp_path / "j.csv", index=False)
    rows, impl = tev._evaluate_checkpoint(_ckpt(workspace), pairs,
                                          str(tmp_path / "t"), 16, "best",
                                          device="cpu")
    tev.write_csv(rows, tmp_path / "t.csv")
    with open(tmp_path / "j.csv") as fj, open(tmp_path / "t.csv") as ft:
        want, got = list(csv.reader(fj)), list(csv.reader(ft))
    assert got[0] == want[0]
    assert len(got) == len(want) == 4 * N_PAIRS + 1
    assert impl == jimpl
    col = got[0].index
    for row, wrow in zip(got[1:], want[1:]):
        assert row[col("checkpoint")] == "best"
        for k in ("epochs", "batch_size", "base_filters", "val_loss"):
            assert float(row[col(k)]) == float(wrow[col(k)]), k
    # the figures of the first 5 pairs, with matplotlib installed
    assert len(os.listdir(tmp_path / "t" / "qualitative" / "best")) == 5


def test_report_implementation_details_matches_jax(workspace, tmp_path):
    """The same dict from a checkpoint's sidecar, from a ``.pth`` without
    one, and from a path that does not exist."""
    pth = str(tmp_path / "best_model_unet.pth")
    export_torch_checkpoint.export(_ckpt(workspace), pth)
    for path in (_ckpt(workspace), pth, str(tmp_path / "none.msgpack")):
        assert tev.report_implementation_details(path) == \
            jeval.report_implementation_details(path)
    got = tev.report_implementation_details(_ckpt(workspace))
    assert got == {"epochs": 3, "batch_size": 4, "learning_rate": 1e-4,
                   "weight_decay": 1e-5, "ssim_weight": 0.3,
                   "perceptual_weight": 0.0, "base_filters": 16,
                   "val_loss": 0.125, "val_ssim": 0.75, "epoch": 2}


def _tie_groups(rows):
    groups = {}
    for w, h, c in rows:
        groups.setdefault(c, set()).add((w, h))
    return [(c, groups[c]) for c in sorted(groups, reverse=True)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_resolutions_matches_jax(seed):
    """The same (width, height, count) rows as JAX's DataFrame, most
    frequent first; rows of equal count compared as a set (pandas'
    quicksort does not keep their order). The invalid entries are
    dropped by both, and the printed table is pandas'."""
    rng = np.random.default_rng(seed)
    sizes = [(256, 256), (192, 256), (256, 192), (512, 512), (240, 240)]
    res = [sizes[i] for i in rng.integers(0, len(sizes), 40)]
    res += [None, (1, 2, 3), [4, 5]]
    got = tres.analyze_resolutions(res)
    df = jres.analyze_resolutions(res)
    want = [tuple(int(v) for v in r) for r in df.itertuples(index=False)]
    assert list(df.columns) == list(tres.COLUMNS)
    assert [c for _, _, c in got] == [c for _, _, c in want]
    assert _tie_groups(got) == _tie_groups(want)
    import pandas as pd
    ordered = pd.DataFrame(got, columns=list(tres.COLUMNS))
    assert tres.format_table(got) == ordered.to_string(index=False)
    assert tres.analyze_resolutions([None]) == []
    assert jres.analyze_resolutions([None]).empty


def test_cli_checkpoint_and_directory_modes_write_the_jax_files(
        workspace, tmp_path, monkeypatch, capsys):
    """``--checkpoint`` writes metrics.csv (4 rows a pair) and report.json
    (hardware, dataset, implementation); ``--ablation_checkpoints_dir``
    over a ``.ckpt`` and a reference ``.pth`` writes report_base.json,
    metrics_ablation.csv and ablation_summary.json. ``--device cpu`` is
    ``--cpu``."""
    monkeypatch.chdir(tmp_path)
    common = ["--hr_dir", str(workspace / "hr"), "--lr_dir",
              str(workspace / "lr")]
    out = tmp_path / "single"
    assert tev.main(common + ["--checkpoint", _ckpt(workspace),
                              "--output_dir", str(out), "--device",
                              "cpu"]) == 0
    with open(out / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4 * N_PAIRS
    assert {r["method"] for r in rows} == set(METHODS)
    with open(out / "report.json") as f:
        report = json.load(f)
    assert set(report) == {"hardware", "dataset", "implementation"}
    assert report["hardware"]["backend"] == "cpu"
    assert report["dataset"]["n_images"] == N_PAIRS
    assert report["dataset"]["subjects"] == ["00", "01", "02"]
    assert report["implementation"]["base_filters"] == 16

    d = tmp_path / "ckpts"
    d.mkdir()
    for suffix in (".ckpt", ".json"):
        with open(str(workspace / "ckpt" / "best_model_unet") + suffix,
                  "rb") as f:
            (d / f"a{suffix}").write_bytes(f.read())
    # a reference .pth of the width that mode evaluates at (32, as JAX)
    wide = build_model(ModelConfig(base_filters=32),
                       generator=torch.Generator().manual_seed(0))
    torch.save(export_torch_checkpoint.torch_checkpoint_dict(
        wide.state_dict(), {}), str(d / "b.pth"))
    out = tmp_path / "ablation"
    assert tev.main(common + ["--ablation_checkpoints_dir", str(d),
                              "--output_dir", str(out), "--cpu"]) == 0
    assert os.path.exists(out / "report_base.json")
    with open(out / "metrics_ablation.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["checkpoint"] for r in rows] == \
        ["a"] * (4 * N_PAIRS) + ["b"] * (4 * N_PAIRS)
    with open(out / "ablation_summary.json") as f:
        assert set(json.load(f)) == {"a.ckpt", "b.pth"}
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tev.main(common + ["--ablation_checkpoints_dir", str(empty),
                              "--output_dir", str(out), "--cpu"]) == 1
    capsys.readouterr()


def test_ablation_train_commands_match_jax(workspace, tmp_path, monkeypatch,
                                           capsys):
    """``--ablation_train_configs``: the train command of each
    configuration is JAX's with its script swapped for the port's train
    module (``--cpu`` only when asked)."""
    monkeypatch.chdir(tmp_path)
    configs = tmp_path / "configs.json"
    configs.write_text(json.dumps([{"ssim_weight": 0.5},
                                   {"ssim_weight": 0.2,
                                    "perceptual_weight": 0.1}]))
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd))
    flags = ["--hr_dir", str(workspace / "hr"), "--lr_dir",
             str(workspace / "lr"), "--ablation_train_configs",
             str(configs), "--train_epochs", "2", "--output_dir",
             str(tmp_path / "out")]
    for cpu in ([], ["--cpu"]):
        calls.clear()
        monkeypatch.setattr(sys, "argv", ["evaluate.py"] + flags + cpu)
        jeval.main()
        want = list(calls)
        calls.clear()
        assert tev.main(flags + ["--cpu"] + cpu) == 0
        assert len(calls) == len(want) == 2
        for got, w in zip(calls, want):
            assert got[:3] == [sys.executable, "-m",
                               "mri_superresolution_torch.cli.train"]
            assert w[1].endswith(os.path.join("scripts", "train.py"))
            assert got[3:] == w[2:] + ["--cpu"] * (not cpu)
    capsys.readouterr()


def test_ablation_train_configs_trains_in_a_child_process(
        workspace, tmp_path, monkeypatch, capsys):
    """One configuration trained for an epoch by the train CLI in a
    child process (from another working directory, on the CPU), then
    evaluated: metrics_ablation.csv and ablation_summary.json."""
    monkeypatch.chdir(tmp_path)
    configs = tmp_path / "configs.json"
    configs.write_text(json.dumps([{"ssim_weight": 0.5}]))
    out = tmp_path / "out"
    assert tev.main(["--hr_dir", str(workspace / "hr"), "--lr_dir",
                     str(workspace / "lr"), "--ablation_train_configs",
                     str(configs), "--train_epochs", "1",
                     "--train_batch_size", "4", "--train_full_res_dir",
                     str(workspace / "hr"), "--train_low_res_dir",
                     str(workspace / "lr"), "--output_dir", str(out),
                     "--cpu"]) == 0
    name = "ssim_0.5_perc_0.0"
    assert os.path.exists(tmp_path / "ablation_checkpoints" / name /
                          "final_model_unet.ckpt")
    with open(out / "metrics_ablation.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4 * N_PAIRS and {r["checkpoint"] for r in rows} == \
        {name}
    with open(out / "ablation_summary.json") as f:
        summary = json.load(f)
    assert summary[name]["ssim_weight"] == 0.5
    assert summary[name]["base_filters"] == 32
    assert os.path.exists(out / name / "metrics.csv")
    assert os.path.exists(out / name / "report.json")
    capsys.readouterr()


def test_cli_refuses_to_run_without_a_gpu_unless_asked(workspace, tmp_path):
    """Without ``--cpu`` the CLI wants the card; here, with none, it
    stops before any work."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tev.main(["--hr_dir", str(workspace / "hr"), "--lr_dir",
                  str(workspace / "lr"), "--checkpoint", _ckpt(workspace),
                  "--output_dir", str(tmp_path / "o"), "--device", "cuda"])
    assert not os.path.exists(tmp_path / "o")


def test_report_hardware_reads_the_host_without_psutil():
    """RAM from ``os.sysconf`` (psutil's total, where psutil exists),
    cores, and the CPU device."""
    info = tev.report_hardware("cpu")
    assert info["backend"] == "cpu" and info["n_devices"] == 1
    assert info["cpu_count"] == os.cpu_count() and info["ram_gb"] > 0
    psutil = pytest.importorskip("psutil")
    assert info["ram_gb"] == round(psutil.virtual_memory().total / 1e9, 2)


def test_figures_are_skipped_without_matplotlib(monkeypatch):
    """Without matplotlib a figure function writes nothing, with one
    warning a figure; the table still prints."""
    import logging

    from mri_superresolution_torch.utils import figures
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("mri_superresolution_torch")
    logger.addHandler(handler)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    try:
        assert figures.pyplot() is None
        assert not tres.visualize_resolution_histogram(
            [(4, 4, 1)], os.devnull)
    finally:
        logger.removeHandler(handler)
    assert sum("matplotlib is not installed" in r.getMessage()
               for r in records) == 2
    out = io.StringIO()
    print(tres.format_table([(4, 4, 1)]), file=out)
    assert out.getvalue() == " Width  Height  Count\n     4       4      1\n"
