"""The port's remaining scripts against the JAX package's on the CPU:
``cli/test_comparison.py``, ``cli/test_model.py``,
``cli/visualise_res.py``, ``cli/compare_ssim_detailed.py``,
``cli/test_ssim_weights.py``, the TUI ``cli/ui.py`` and the checkpoint
converters ``tools/export_torch_checkpoint.py`` and
``tools/convert_torch_checkpoint.py``. Small data: two NIfTI volumes of
40 x 36 x 24 and 44 x 32 x 20, a unet of base filters 16 whose JAX
weights both packages load."""

import logging
import os
import random
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mri_superresolution_tpu import nifti as jnifti
from mri_superresolution_tpu.evalsuite import resolution as jres
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.train import checkpoint as jckpt
from mri_superresolution_tpu.utils import torch_compat
from mri_superresolution_torch import native
from mri_superresolution_torch.cli import compare_ssim_detailed as tcsd
from mri_superresolution_torch.cli import test_comparison as ttc
from mri_superresolution_torch.cli import test_model as ttm
from mri_superresolution_torch.cli import test_ssim_weights as tsw
from mri_superresolution_torch.cli import ui as tui
from mri_superresolution_torch.cli import visualise_res as tvr
from mri_superresolution_torch.config import (InferConfig, ModelConfig,
                                              TrainConfig, to_dict)
from mri_superresolution_torch.data import extraction as tx
from mri_superresolution_torch.evalsuite import resolution as tres
from mri_superresolution_torch.infer import load_engine
from mri_superresolution_torch.tools import (convert_torch_checkpoint,
                                             export_torch_checkpoint)
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.weights import state_dict_from_jax
from scripts import test_comparison as jtc
from scripts import test_model as jtm
from scripts import test_ssim_weights as jsw
from scripts import ui as jui

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((40, 36, 24), (44, 32, 20))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """datasets/s1/sub-0{1,2}/anat/*.nii.gz (float volumes of SHAPES) and
    ckpt/best_model_unet.ckpt (JAX's initial unet, base filters 16)."""
    ws = tmp_path_factory.mktemp("scripts_ws")
    rng = np.random.default_rng(3)
    for i, shape in enumerate(SHAPES, 1):
        anat = ws / "datasets" / "s1" / f"sub-0{i}" / "anat"
        anat.mkdir(parents=True)
        jnifti.save(str(anat / f"sub-0{i}_T1w.nii.gz"),
                    (rng.random(shape) * 500).astype(np.float32))
    (ws / "ckpt").mkdir()
    params = jax.tree_util.tree_map(np.asarray, init_params(
        JaxUNet(base_filters=16, initial_alpha=25.0), jax.random.key(0),
        (16, 16)))
    cfg = TrainConfig(model=ModelConfig(base_filters=16, initial_alpha=25.0))
    ckpt.save_checkpoint(str(ws / "ckpt" / "best_model_unet"),
                         state_dict_from_jax(params),
                         meta={"config": to_dict(cfg), "epoch": 4,
                               "val_loss": 0.25, "val_ssim": 0.5})
    return ws


def _logger():
    return logging.getLogger("test_torch_eval_scripts")


def _decoded(folder):
    return {f: native.imread_gray(os.path.join(folder, f))
            for f in sorted(os.listdir(folder)) if f.endswith(".png")}


# --------------------------------------------------------- test_comparison

def _fake_extract(names):
    """An extractor that writes ``names`` as blank PNG pairs."""
    def extract(nifti_file, hr_dir, lr_dir, **kwargs):
        for n in names:
            for d, s in ((hr_dir, 8), (lr_dir, 4)):
                native.imwrite_gray(os.path.join(d, n),
                                    np.zeros((s, s), np.uint8))
        return list(names)
    return extract


def test_pair_pick_ignores_the_filesystem_order(workspace, tmp_path,
                                                monkeypatch):
    """The pair ``--seed`` picks. JAX's ``extract_test_slice`` draws from
    ``os.listdir``'s order, so the same seed picks another pair when a
    filesystem lists the same files in another order; the port draws from
    the sorted names, the same pair whatever the order (ROADMAP C)."""
    import mri_superresolution_tpu.data as jdata
    names = [f"sub-01_T1w_s{i:03d}.png" for i in range(10, 20)]
    monkeypatch.setattr(jdata, "extract_from_nifti", _fake_extract(names))
    monkeypatch.setattr(tx, "extract_from_nifti", _fake_extract(names))
    listdir = os.listdir

    def picks(order, seed):
        monkeypatch.setattr(os, "listdir",
                            lambda d: order(sorted(listdir(d))))
        out = {}
        for pkg, fn in (("jax", jtc.extract_test_slice),
                        ("port", ttc.extract_test_slice)):
            d = tmp_path / f"{pkg}_{order.__name__}_{seed}"
            (d / "hr").mkdir(parents=True)
            (d / "lr").mkdir()
            random.seed(seed)
            pair = fn(str(workspace / "datasets"), str(d / "hr"),
                      str(d / "lr"), _logger(), seed)
            out[pkg] = os.path.basename(pair["hr"])
        monkeypatch.setattr(os, "listdir", listdir)
        return out

    def forward(names):
        return names

    def backward(names):
        return names[::-1]

    moved = 0
    for seed in range(4):
        a, b = picks(forward, seed), picks(backward, seed)
        assert a["port"] == b["port"] == random.Random(seed).choice(names)
        moved += a["jax"] != b["jax"]
    assert moved > 0


def _table(path):
    with open(path) as f:
        return f.read().splitlines()


def test_cli_comparison_writes_the_jax_table(workspace, tmp_path,
                                             monkeypatch):
    """``cli.test_comparison`` on the CPU and JAX's script on the same
    volume and checkpoint: metrics.txt has the same title, header and
    methods in the same order, and each row the same number formats. The
    port extracts from the first volume in sorted order (sub-01); JAX from
    the first its walk meets, which the filesystem decides."""
    monkeypatch.chdir(tmp_path)
    common = ["--test_dataset", str(workspace / "datasets"),
              "--checkpoint_dir", str(workspace / "ckpt"), "--seed", "0",
              "--cpu"]
    assert ttc.main(common + ["--output_dir", str(tmp_path / "t")]) == 0
    monkeypatch.setattr(sys, "argv", ["test_comparison.py"] + common +
                        ["--output_dir", str(tmp_path / "j")])
    assert jtc.main() == 0
    got, want = _table(tmp_path / "t" / "metrics.txt"), \
        _table(tmp_path / "j" / "metrics.txt")
    assert len(got) == len(want) == 10
    assert got[0] == want[0] and got[3:6] == want[3:6]
    assert re.fullmatch(r"Test file: sub-01_T1w_s\d{3}\.png", got[2])
    row = re.compile(r"\| (.+) \| -?\d\.\d{4} \| -?\d+\.\d{2} \| \d\.\d{6} "
                     r"\| \d\.\d{4} \| \d\.\d{4} \|")
    methods = [row.fullmatch(ln).group(1) for ln in got[6:]]
    assert methods == [row.fullmatch(ln).group(1) for ln in want[6:]] == \
        ["AI Model", "Bilinear", "Sharp Bilinear", "Bicubic"]
    assert os.path.exists(tmp_path / "t" / "comparison.png")


# -------------------------------------------------------------- test_model

@pytest.mark.parametrize("avg,want", [((36, 40), (40, 20)),
                                      ((41, 33), (48, 24)),
                                      ((64, 64), (64, 32))])
def test_square_sizes(avg, want):
    assert ttm.square_sizes(*avg) == want


def test_extract_test_slices_pads_and_samples_as_jax(workspace, tmp_path,
                                                     monkeypatch):
    """``extract_test_slices`` of both packages on two volumes of other
    sizes, the port's with JAX's extraction under it (the same draws):
    the same average size, square %8 canvases, re-padded PNGs code for
    code and the same ``random.sample`` of the pairs. With the port's own
    extraction: the same canvases and sample, and the HR codes within the
    extraction's gate (tests/test_torch_extract.py)."""
    import mri_superresolution_tpu.data as jdata
    ds = str(workspace / "datasets")
    random.seed(5)
    want = jtm.extract_test_slices(ds, str(tmp_path / "jhr"),
                                   str(tmp_path / "jlr"), 6, _logger(), 7)
    # each file's key as JAX's walk order hands it out
    jfiles = jdata.find_nifti_files(ds)
    keys = dict(zip(jfiles, _jax_subkeys(7, len(jfiles))))

    def jax_extract(nifti_file, hr_dir, lr_dir, seed=None, device=None,
                    **kw):
        return jdata.extract_from_nifti(nifti_file, hr_dir, lr_dir,
                                        rng_key=keys[nifti_file], **kw)

    monkeypatch.setattr(tx, "extract_from_nifti", jax_extract)
    random.seed(5)
    got = ttm.extract_test_slices(ds, str(tmp_path / "thr"),
                                  str(tmp_path / "tlr"), 6, _logger(), 7,
                                  "cpu")
    monkeypatch.undo()
    assert [tuple(os.path.basename(p) for p in pair) for pair in got] == \
        [tuple(os.path.basename(p) for p in pair) for pair in want]
    assert len(got) == 6
    for d in ("hr", "lr"):
        a, b = _decoded(tmp_path / f"t{d}"), _decoded(tmp_path / f"j{d}")
        assert list(a) == list(b)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f])
    # avg 42 x 38 -> HR canvases 48^2, LR 24^2
    assert {v.shape for v in _decoded(tmp_path / "thr").values()} == \
        {(48, 48)}
    assert {v.shape for v in _decoded(tmp_path / "tlr").values()} == \
        {(24, 24)}

    random.seed(5)
    own = ttm.extract_test_slices(ds, str(tmp_path / "ohr"),
                                  str(tmp_path / "olr"), 6, _logger(), 7,
                                  "cpu")
    assert [os.path.basename(a) for a, _ in own] == \
        [os.path.basename(a) for a, _ in want]
    a, b = _decoded(tmp_path / "ohr"), _decoded(tmp_path / "jhr")
    d = np.concatenate([np.abs(a[f].astype(int) - b[f].astype(int)).ravel()
                        for f in a])
    assert list(a) == list(b) and (d == 0).mean() >= 0.999 and d.max() <= 1
    assert {v.shape for v in _decoded(tmp_path / "olr").values()} == \
        {(24, 24)}


def _jax_subkeys(seed, n):
    """The keys JAX's ``extract_test_slices`` passes to its ``n`` files:
    ``key, sub = split(key)`` from ``key(seed)``."""
    key, subs = jax.random.key(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def test_cli_test_model_runs_and_reports_averages(workspace, tmp_path,
                                                  monkeypatch, capsys):
    """The test_model CLI on the CPU: one enhanced PNG a sampled pair at
    twice the LR canvas, the average metrics logged, the summary grid."""
    monkeypatch.chdir(tmp_path)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("mri_superresolution_torch")
    logger.addHandler(handler)
    try:
        assert ttm.main(["--test_dataset", str(workspace / "datasets"),
                         "--output_dir", str(tmp_path / "out"),
                         "--checkpoint_dir", str(workspace / "ckpt"),
                         "--n_slices", "4", "--cpu"]) == 0
    finally:
        logger.removeHandler(handler)
    outs = _decoded(tmp_path / "out" / "enhanced")
    assert len(outs) == 4 and {v.shape for v in outs.values()} == {(48, 48)}
    text = [r.getMessage() for r in records]
    for k in ("SSIM", "RMSE", "MAE"):
        assert any(t.startswith(f"Average {k}: ") for t in text), k
    assert os.path.exists(tmp_path / "out" / "results_summary.png")
    capsys.readouterr()


# ------------------------------------------------------------ visualise_res

def test_middle_slices_and_table_match_jax(workspace, tmp_path, capsys):
    """``extract_middle_slice`` of both packages on 3D, 4D and 2D files:
    the same sizes (None for 2D) and PNG codes; the CLI prints the table
    and exits 1 on an empty tree."""
    files = tx.find_nifti_files(str(workspace / "datasets"))
    four = str(tmp_path / "sub-04_bold.nii.gz")
    jnifti.save(four, np.random.default_rng(0).random((20, 18, 6, 2))
                .astype(np.float32))
    flat = str(tmp_path / "sub-05_T1w.nii")
    jnifti.save(flat, np.ones((8, 8), np.float32))
    for f in files + [four, flat]:
        w = jres.extract_middle_slice(f, str(tmp_path / "j"))
        g = tres.extract_middle_slice(f, str(tmp_path / "t"))
        assert g == w
    assert [g for g in map(tres.extract_middle_slice, files)] == \
        [(36, 40), (32, 44)]
    a, b = _decoded(tmp_path / "t"), _decoded(tmp_path / "j")
    assert list(a) == list(b) and len(a) == 3
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])
    assert tvr.main(["--root_dir", str(workspace / "datasets"),
                     "--output_png_dir", str(tmp_path / "png"),
                     "--output_viz_file", str(tmp_path / "h.png")]) == 0
    out = capsys.readouterr().out
    assert " Width  Height  Count" in out and "Found 2 NIfTI files" in out
    assert os.path.exists(tmp_path / "h_scatter.png")
    assert tvr.main(["--root_dir", str(tmp_path / "none")]) == 1
    capsys.readouterr()


# ----------------------------------------------- SSIM sweep and comparison

def test_sweep_commands_match_jax(tmp_path, monkeypatch, capsys):
    """Each weight's train command is JAX's with its script swapped for
    the port's train module; the runs' directories are JAX's."""
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd))
    flags = ["--full_res_dir", "hr", "--low_res_dir", "lr",
             "--ssim_weights", "0.2", "0.7", "--epochs", "1",
             "--augmentation", "--use_amp", "--cpu"]
    monkeypatch.setattr(sys, "argv", ["test_ssim_weights.py"] + flags +
                        ["--output_dir", str(tmp_path / "j")])
    jsw.main()
    want = list(calls)
    calls.clear()
    out = tsw.main(flags + ["--output_dir", str(tmp_path / "t")])
    assert len(calls) == len(want) == 2
    def norm(a):
        return re.sub(r"^.*/[jt]_\d{8}_\d{6}", "X", a)

    for got, w in zip(calls, want):
        assert got[:3] == [sys.executable, "-m",
                           "mri_superresolution_torch.cli.train"]
        assert [norm(a) for a in got[3:]] == [norm(a) for a in w[2:]]
    assert sorted(os.listdir(out)) == ["ssim_weight_0.2", "ssim_weight_0.7",
                                       "ssim_weight_comparison.png"]
    capsys.readouterr()


def test_collage_of_the_sample_grids(tmp_path, monkeypatch):
    """The collage reads each run's latest sample grid, and without
    matplotlib it is skipped."""
    dirs = {}
    for w in (0.0, 0.5):
        d = tmp_path / f"ssim_weight_{w}" / "samples"
        d.mkdir(parents=True)
        native.imwrite_gray(str(d / "comparison_epoch_0.png"),
                            np.full((12, 30), 90, np.uint8))
        dirs[w] = str(d.parent)
    assert tsw.create_ssim_weight_collage(dirs, str(tmp_path / "c.png"))
    assert os.path.exists(tmp_path / "c.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not tsw.create_ssim_weight_collage(dirs, str(tmp_path / "d.png"))
    assert not os.path.exists(tmp_path / "d.png")


def test_detailed_comparison_runs_every_model_on_each_image(
        workspace, tmp_path, capsys):
    """Two ``ssim_weight_{w}`` runs (one checkpoint each) and 6 test
    images (the first 5 run): per image the original, one full-resolution
    output a weight (the engine's output as 8 bits) and the figure."""
    sweep = tmp_path / "sweep"
    for w in ("0.3", "0.7"):
        d = sweep / f"ssim_weight_{w}"
        d.mkdir(parents=True)
        for suffix in (".ckpt", ".json"):
            src = str(workspace / "ckpt" / "best_model_unet") + suffix
            with open(src, "rb") as f:
                (d / f"best_model_unet{suffix}").write_bytes(f.read())
    (sweep / "ssim_weight_x").mkdir()
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        native.imwrite_gray(str(imgs / f"s{i}.png"),
                            (rng.random((16, 24)) * 255).astype(np.uint8))
    assert tcsd.find_weight_dirs(str(sweep)).keys() == {0.3, 0.7}
    assert tcsd.main(["--weight_dirs", str(sweep), "--test_image_dir",
                      str(imgs), "--output_dir", str(tmp_path / "out"),
                      "--cpu"]) == 0
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == [f"s{i}" for i in range(5)]
    eng = load_engine(InferConfig(checkpoint_dir=str(sweep /
                                                     "ssim_weight_0.3")),
                      device="cpu")
    raw = native.imread_gray(str(imgs / "s0.png"))
    want = np.clip(eng.upscale_image(raw.astype(np.float32) / 255.0) * 255,
                   0, 255).astype(np.uint8)
    assert sorted(os.listdir(out / "s0")) == [
        "comparison.png", "original.png", "weight_0.3.png",
        "weight_0.7.png"]
    np.testing.assert_array_equal(
        native.imread_gray(str(out / "s0" / "weight_0.3.png")), want)
    np.testing.assert_array_equal(
        native.imread_gray(str(out / "s0" / "original.png")), raw)
    capsys.readouterr()


# ------------------------------------------------------------- converters

def test_exported_pth_is_the_jax_export_bit_for_bit(workspace, tmp_path):
    """``.ckpt`` -> ``.pth``: the reference dict of JAX's
    ``save_torch_checkpoint`` from the same checkpoint, every tensor
    bit-equal; a family other than the unet is refused."""
    src = str(workspace / "ckpt" / "best_model_unet.ckpt")
    export_torch_checkpoint.main(["--ckpt", src, "--out",
                                  str(tmp_path / "t.pth")])
    params, meta = jckpt.load_params_any(src)
    torch_compat.save_torch_checkpoint(str(tmp_path / "j.pth"), params, meta)
    got = torch.load(tmp_path / "t.pth", weights_only=True)
    want = torch.load(tmp_path / "j.pth", weights_only=True)
    assert {k: v for k, v in got.items() if k != "model_state_dict"} == \
        {k: v for k, v in want.items() if k != "model_state_dict"} == \
        {"epoch": 4, "val_loss": 0.25, "val_ssim": 0.5}
    gs, ws = got["model_state_dict"], want["model_state_dict"]
    assert sorted(gs) == sorted(ws)
    for k in ws:
        assert gs[k].dtype == ws[k].dtype == torch.float32, k
        assert torch.equal(gs[k], ws[k]), k
    other = tmp_path / "edsr"
    ckpt.save_checkpoint(str(other), {k: v for k, v in
                                      _edsr_state().items()},
                         meta={"config": {"model": {"model_type": "edsr"}}})
    with pytest.raises(SystemExit, match="only the 'unet' family"):
        export_torch_checkpoint.export(str(other) + ".ckpt",
                                       str(tmp_path / "e.pth"))


def _edsr_state():
    from mri_superresolution_torch.models import build_model
    return build_model(ModelConfig(model_type="edsr", base_filters=16,
                                   num_blocks=1)).state_dict()


def test_pth_to_ckpt_round_trips(workspace, tmp_path):
    """``.pth`` -> ``.ckpt`` -> the port's params: the same tensors, and
    the ``.pth``'s epoch and validation results in the sidecar; JAX loads
    the ``.ckpt`` and a ``.msgpack`` to JAX's own conversion of the
    ``.pth``."""
    src = str(workspace / "ckpt" / "best_model_unet.ckpt")
    pth = str(tmp_path / "m.pth")
    export_torch_checkpoint.export(src, pth)
    convert_torch_checkpoint.main(["--pth", pth, "--out",
                                   str(tmp_path / "m.ckpt")])
    sd, meta = ckpt.load_params_any(str(tmp_path / "m.ckpt"))
    orig, _ = ckpt.load_params_any(src)
    assert sorted(sd) == sorted(orig)
    for k in orig:
        assert torch.equal(sd[k], orig[k]), k
    assert (meta["epoch"], meta["val_loss"], meta["val_ssim"]) == \
        (4, 0.25, 0.5)
    want = torch_compat.load_torch_checkpoint(pth)
    for path in (str(tmp_path / "m.ckpt"), str(tmp_path / "m.msgpack")):
        if path.endswith(".msgpack"):
            convert_torch_checkpoint.convert(pth, path)
        got, _ = jckpt.load_params_any(path)
        ga = jax.tree_util.tree_leaves_with_path(got)
        wa = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(ga) == len(wa)
        for k, v in ga:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(wa[k]))


# -------------------------------------------------------------------- TUI

def _param_sets():
    base = dict(tui.DEFAULT_PARAMS, seed=1234)
    on = dict(base)
    for k, v in base.items():
        if isinstance(v, bool):
            on[k] = not v
    on.update(target_image="hr.png", checkpoint_file="c/best.ckpt",
              artifact_file="m.mrisrt", spatial_shards=2, out_dtype="int16",
              input_image="in.png")
    return [base, on]


@pytest.mark.parametrize("menu", ["extract_paired", "train", "infer",
                                  "serve"])
def test_tui_commands_are_the_jax_flags_after_the_module(menu):
    """For every menu, with every toggle off and on: JAX's command with
    its script swapped for ``-m mri_superresolution_torch.cli.<name>``."""
    assert tui.MENUS == jui.MENUS and tui.BOOLEAN_FLAGS == jui.BOOLEAN_FLAGS
    assert tui.DISCRETE == jui.DISCRETE
    assert {k: v for k, v in tui.DEFAULT_PARAMS.items() if k != "seed"} == \
        {k: v for k, v in jui.DEFAULT_PARAMS.items() if k != "seed"}
    name = {"extract_paired": "extract"}.get(menu, menu)
    for p in _param_sets():
        got, want = tui.build_command(menu, p), jui.build_command(menu, p)
        assert got[:3] == [sys.executable, "-m",
                           f"mri_superresolution_torch.cli.{name}"]
        assert got[3:] == want[2:]
    with pytest.raises(ValueError):
        tui.build_command("nope", _param_sets()[0])


@pytest.mark.parametrize("field,raw", [
    ("ssim_weight", "0.5"), ("ssim_weight", "0.9"), ("ssim_weight", "1.5"),
    ("perceptual_weight", "0.8"), ("kspace_crop_factor", "0"),
    ("kspace_crop_factor", "1"), ("kspace_crop_factor", "1.2"),
    ("validation_split", "0.3"), ("target_size", "128 96"),
    ("target_size", "256"), ("batch_size", "0"), ("epochs", "7"),
    ("augmentation", "yes"), ("ema_decay", "1.0"), ("learning_rate", "3e-4"),
    ("log_dir", "./x")])
def test_tui_validation_matches_jax(field, raw):
    p = dict(tui.DEFAULT_PARAMS, perceptual_weight=0.2)

    def run(fn):
        try:
            return ("ok", fn(field, raw, dict(p)))
        except ValueError as e:
            return ("error", str(e))
    assert run(tui.validate) == run(jui.validate)


def test_tui_renders_its_menu_and_quits():
    """``python -m mri_superresolution_torch.cli.ui`` under a pty: the main
    menu within 15 s, and ``q`` ends it."""
    import pty
    import select
    import signal
    import time

    pid, fd = pty.fork()
    if pid == 0:
        os.environ["TERM"] = "xterm"
        os.environ["PYTHONPATH"] = ROOT
        os.execvp(sys.executable, [sys.executable, "-m",
                                   "mri_superresolution_torch.cli.ui"])
    out = b""
    try:
        deadline = time.time() + 15
        while time.time() < deadline and \
                b"Start Inference Server" not in out:
            if select.select([fd], [], [], 0.3)[0]:
                try:
                    out += os.read(fd, 65536)
                except OSError:
                    break
        for text in (b"MRI Super-Resolution Tool", b"Extract Paired Slices",
                     b"Train Super-Resolution Model",
                     b"Start Inference Server"):
            assert text in out, out[-2000:]
        os.write(fd, b"q")
        deadline = time.time() + 10
        while time.time() < deadline:
            done, _ = os.waitpid(pid, os.WNOHANG)
            if done:
                pid = 0
                break
            time.sleep(0.2)
        assert pid == 0, "the TUI did not exit on 'q'"
    finally:
        if pid:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        os.close(fd)
