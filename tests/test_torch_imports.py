"""Importing any module of the port must pull in nothing of JAX, initialise
no CUDA context and import no triton (kernels build at first use)."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "mri_superresolution_tpu", "triton"))
assert not bad, bad
assert not torch.cuda.is_initialized()
print("OK", len(names))
"""


def test_port_imports_are_clean():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout,
                                                    r.stderr[-2000:])
    # every module of the port was walked, the kernels and the CLI included
    assert int(r.stdout.split()[-1]) >= 20
