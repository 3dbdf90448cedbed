"""Importing any module of the port, or ``chip_smoke.py``, must pull in
nothing of JAX or of the repo's ``tools/``, initialise no CUDA context and
import no triton (kernels build at first use). Nor pandas or psutil, which
the card's machine may lack, nor matplotlib, which only the figure
functions import."""

import os
import subprocess
import sys

_PROBE = """
import importlib, pkgutil, sys
import torch
import mri_superresolution_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tools",
                                    "mri_superresolution_tpu", "triton",
                                    "pandas", "psutil", "matplotlib"))
assert not bad, bad
assert not torch.cuda.is_initialized()
print("OK", " ".join(names), len(names))
"""


def test_port_imports_are_clean():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout,
                                                    r.stderr[-2000:])
    # every module of the port was walked, the kernels and the CLIs
    # included
    assert int(r.stdout.split()[-1]) >= 20
    walked = set(r.stdout.split())
    for name in ("cli.extract", "data.extraction", "ops.kspace",
                 "ops.pipeline", "evalsuite.baselines", "tools.quality",
                 "infer.server", "cli.serve", "cli.evaluate",
                 "cli.test_comparison", "cli.test_model",
                 "cli.compare_ssim_detailed", "cli.test_ssim_weights",
                 "cli.visualise_res", "cli.ui", "evalsuite.resolution",
                 "tools.export_torch_checkpoint",
                 "tools.convert_torch_checkpoint", "utils.figures",
                 "utils.subproc", "parallel", "parallel.mesh",
                 "parallel.multihost", "train.zero1", "tools.dp_step",
                 "experiments", "experiments.phase", "tools.ema_quality",
                 "tools.soak_server", "tools.vgg_quality",
                 "tools.edsr_convergence", "tools.fetch_vgg_weights"):
        assert f"mri_superresolution_torch.{name}" in walked
