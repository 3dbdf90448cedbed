"""Human-readable logging to stderr and a log file."""

from __future__ import annotations

import logging
import sys


def setup_logging(logfile: str = "training.log",
                  name: str = "mri_superresolution_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    # child loggers (e.g. ...torch.infer) must not re-emit through the root
    # package logger's handlers — that double-prints every line
    logger.propagate = False
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        try:
            fh = logging.FileHandler(logfile)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:
            pass
    return logger
