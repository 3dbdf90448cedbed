"""On the card: one short run of each cell through the runner, as the
driver runs it, with a JSON result line. Marked ``cuda``; each test
skips where no card is visible."""

import json
import subprocess
import sys

import pytest

from benchmark import core

MAN = core.manifest()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 33 + 5), "--seconds", "2", "--trace", "0"],
        cwd=str(core.ROOT), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]
