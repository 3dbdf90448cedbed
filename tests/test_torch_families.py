"""The table of model families (``models/families.py``) is the one place
that knows them: a family registered in the table alone builds, saves,
loads, is found, serves and is taken by every CLI; each CLI's
``--model_type`` lists the table; the widths a checkpoint's weights fix
win on resume as in serving; and no module outside the family code names
a family."""

import argparse
import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest
import torch

from mri_superresolution_torch import native
from mri_superresolution_torch.config import (InferConfig, ModelConfig,
                                              to_dict)
from mri_superresolution_torch.infer import InferenceEngine, load_engine
from mri_superresolution_torch.models import SimpleSR, build_model, families
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import edsr_num_blocks

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# each CLI with --model_type, and the flags it requires
CLIS = {"infer": ["--input", "a", "--output", "b"],
        "infer_volume": ["--input", "a", "--output", "b"],
        "serve": [], "export_serving": ["--out", "a"],
        "train": ["--full_res_dir", "a", "--low_res_dir", "b"],
        "compare_ssim_detailed": ["--weight_dirs", "a",
                                  "--test_image_dir", "b"]}
# the ports of the JAX package's scripts, which list its families only
JAX_CLIS = {"test_model": [],
            "test_ssim_weights": ["--full_res_dir", "a", "--low_res_dir",
                                  "b"]}
NEW = "simple_copy"


def _parse(cli, argv):
    mod = importlib.import_module(f"mri_superresolution_torch.cli.{cli}")
    return mod.parse_args({**CLIS, **JAX_CLIS}[cli] + argv)


def test_a_family_registered_in_the_table_alone_runs_everywhere(
        monkeypatch, tmp_path):
    """A copy of ``simple``'s record under a new name, and nothing else:
    it builds, saves and loads, checkpoint discovery tells it from
    ``simple``, the engine serves it as ``simple`` is served, and every
    CLI takes it."""
    monkeypatch.setitem(families.FAMILIES, NEW, dataclasses.replace(
        families.FAMILIES["simple"], name=NEW))
    cfg = ModelConfig(model_type=NEW, base_filters=8)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert type(model) is SimpleSR
    sd = model.state_dict()
    base = str(tmp_path / f"best_model_{NEW}")
    ckpt.save_checkpoint(base, sd, meta={"config": {"model": to_dict(cfg)}})

    assert ckpt.find_best_checkpoint(str(tmp_path), NEW) == base + ".ckpt"
    with pytest.raises(FileNotFoundError):      # "simple" is in the name
        ckpt.find_best_checkpoint(str(tmp_path), "simple")
    got, meta = ckpt.load_params_any(base + ".ckpt", "unet")
    assert ckpt.model_type_of(meta) == NEW and set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k

    eng = load_engine(InferConfig(model=ModelConfig(model_type=NEW),
                                  checkpoint_dir=str(tmp_path), bf16=False),
                      device="cpu")
    assert eng.model_cfg == cfg
    x = np.random.default_rng(0).random((2, 16, 16), np.float32)
    want = InferenceEngine(dataclasses.replace(cfg, model_type="simple"), sd,
                           bf16=False, device="cpu").upscale_batch(x)
    np.testing.assert_array_equal(eng.upscale_batch(x), want)

    for cli in {**CLIS, **JAX_CLIS}:
        assert _parse(cli, ["--model_type", NEW]).model_type == NEW, cli


@pytest.mark.parametrize("cli", list(CLIS) + list(JAX_CLIS))
def test_cli_model_types_are_the_tables(cli, monkeypatch):
    """``--model_type``'s choices, in order: every family for the port's
    CLIs, the JAX package's for the ports of its scripts."""
    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        parsers.append(self)
        return parse(self, *a, **k)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    assert _parse(cli, []).model_type == "unet"
    (choices,) = [a.choices for a in parsers[-1]._actions
                  if a.dest == "model_type"]
    want = (list(families.FAMILIES) if cli in CLIS else
            [n for n, f in families.FAMILIES.items() if f.jax])
    assert list(choices) == want
    assert want[:4] == ["unet", "unet_tpu", "edsr", "simple"]


def test_edsr_resumes_at_the_checkpoints_depth(tmp_path, capsys):
    """An EDSR of 3 blocks trained through the train CLI resumes from a
    command line that leaves --num_blocks at its default (8): the depth
    comes from the checkpoint's weights, as serving reads it."""
    from mri_superresolution_torch.cli import train as cli
    hr = phantom_batch(np.random.default_rng(1), 8, 32)
    lr = phantom_batch(np.random.default_rng(1), 8, 16)
    for sub, imgs in (("hr", hr), ("lr", lr)):
        (tmp_path / sub).mkdir()
        for i, img in enumerate(imgs):
            native.imwrite_gray(str(tmp_path / sub / f"sub-{i // 2:02d}_T1w_"
                                    f"s{i:03d}.png"),
                                np.round(img * 255).astype(np.uint8))

    def run(*extra):
        return cli.main([
            "--full_res_dir", str(tmp_path / "hr"), "--low_res_dir",
            str(tmp_path / "lr"), "--model_type", "edsr", "--base_filters",
            "8", "--batch_size", "4", "--seed", "3", "--cpu", "--no_bf16",
            "--checkpoint_dir", str(tmp_path / "ck"), "--log_dir",
            str(tmp_path / "log"), *extra])

    first = ckpt.load_checkpoint(run("--num_blocks", "3", "--epochs", "1"))
    assert cli.parse_args(["--full_res_dir", "a", "--low_res_dir", "b",
                           "--model_type", "edsr"]).num_blocks == 8
    second = ckpt.load_checkpoint(run("--epochs", "2", "--resume"))
    assert "Resumed from" in capsys.readouterr().out
    assert edsr_num_blocks(first[0]) == edsr_num_blocks(second[0]) == 3
    assert second[2]["config"]["model"]["num_blocks"] == 3
    assert second[2]["step"] > first[2]["step"]


# the string literals outside the family code that may name a family:
# the engine's measured-cost warning on unet_tpu int8, and two tools'
# default arguments
ALLOWED = {("infer/engine.py", "unet_tpu"),
           ("infer/engine.py", "--quant int8 on model type 'unet_tpu'"),
           ("tools/edsr_convergence.py", "edsr"),
           ("tools/ema_quality.py", "unet_tpu")}
FAMILY_CODE = ("models/", "utils/weights.py", "parallel/spatial.py")


def test_no_module_outside_the_family_code_names_a_family():
    """Outside the models, their JAX mappings and the row-sharded
    forwards, no string literal (docstrings aside) is or names one of
    the families but ``unet``; paths such as ``models/swinir.py`` are
    not names."""
    import re
    name = re.compile(r"(?<![\w/])(unet_tpu|edsr|swinir)(?![\w.])|^simple$")
    pkg = ROOT / "mri_superresolution_torch"
    found = set()
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(pkg).as_posix()
        if rel.startswith(FAMILY_CODE):
            continue
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for n in ast.walk(tree):
            if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and id(n) not in docs and name.search(n.value)):
                found.add((rel, next((v for f, v in ALLOWED if f == rel
                                      and n.value.startswith(v)), n.value)))
    assert found == ALLOWED
