"""Child processes that run the port's CLIs as modules.

``python -m mri_superresolution_torch.cli.<name>`` finds the package only
where the parent found it, so the child's ``PYTHONPATH`` starts with the
directory that holds the package, whatever the working directory is.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cli_command(name: str) -> List[str]:
    """``[python, "-m", "mri_superresolution_torch.cli.<name>"]``."""
    return [sys.executable, "-m", f"mri_superresolution_torch.cli.{name}"]


def child_env() -> Dict[str, str]:
    """This process's environment with the package's root first on
    ``PYTHONPATH``."""
    env = dict(os.environ)
    rest = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _ROOT + (os.pathsep + rest if rest else "")
    return env
