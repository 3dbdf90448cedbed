"""What the runner and the reference load, checked in a fresh process by
whole top-level module names."""

import json
import subprocess
import sys

from benchmark import core

FORBIDDEN = {"jax", "jaxlib", "flax", "mri_superresolution_tpu"}


def _top_names(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=str(core.ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


RUNNER = """
import benchmark.core as c, benchmark.systems as s, benchmark.faults
import importlib
man = c.manifest()
for w in man["workloads"]:
    c.config(man, w["config"])
for k in ("volume", "train"):
    importlib.import_module("benchmark.kinds." + k)
for m in man["per_layer"]:
    c.reader(m["name"])
s.serving_engine; import mri_superresolution_torch.infer.engine
import mri_superresolution_torch.train.trainer
"""

REFERENCE = """
import benchmark.core as c
import benchmark.reference, benchmark.weights, benchmark.traffic
man = c.manifest()
for w in man["workloads"]:
    c.config(man, w["config"])
"""


def test_runner_loads_no_jax():
    names = _top_names(RUNNER)
    assert "mri_superresolution_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_names(REFERENCE)
    assert not names & (FORBIDDEN | {"mri_superresolution_torch"})


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_free_helper", sys)
    assert "jax" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in core.forbidden_modules()
