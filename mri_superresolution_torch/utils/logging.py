"""Logging: human logs to stderr and a log file, and the training's
JSON-lines protocol on stdout.

The protocol is the JAX package's (``utils/logging.py`` there; reference
scripts/train.py:54-91): one JSON object a line with a ``type`` field —
``params`` / ``batch_update`` / ``epoch_summary`` / ``info`` /
``warning`` — and floats rounded to 6 decimals. Human mirrors go to the
package logger, batch updates excepted.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Union


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


_logger = logging.getLogger("mri_superresolution_torch")
_quiet = False


def set_quiet(quiet: bool = True) -> None:
    """Suppress the stdout protocol lines (data-parallel ranks other than
    rank 0): their messages go to the logger alone."""
    global _quiet
    _quiet = quiet


def log_message(message: Union[dict, str], message_type: str = "info") -> None:
    """Emit one protocol line on stdout and a human line on the logger."""
    if _quiet:
        if message_type != "batch_update":
            text = message if isinstance(message, str) else json.dumps(message)
            (_logger.warning if message_type == "warning"
             else _logger.info)(text)
        return
    if isinstance(message, dict):
        line = dict(message)
        for key, value in line.items():
            if isinstance(value, float):
                line[key] = round(value, 6)
        line["type"] = message_type
        print(json.dumps(line), flush=True)
    else:
        print(json.dumps({"type": message_type, "message": str(message)}),
              flush=True)

    if message_type == "batch_update":
        return  # too chatty for the human log (scripts/train.py:71-73)
    if isinstance(message, dict):
        if message_type == "epoch_summary":
            msg = (f"Epoch {message['epoch'] + 1}/"
                   f"{message.get('total_epochs', '?')} | "
                   f"Train Loss: {message.get('train_loss', 0):.4f} | "
                   f"Train SSIM: {message.get('train_ssim', 0):.4f}")
            if message.get("val_loss") != "N/A":
                msg += (f" | Val Loss: {message.get('val_loss', 0):.4f}"
                        f" | Val SSIM: {message.get('val_ssim', 0):.4f}")
            msg += f" | Time: {message.get('elapsed', 0):.2f}s"
            _logger.info(msg)
        elif message_type == "params":
            params_str = ", ".join(f"{k}={v}" for k, v in message.items()
                                   if k != "type")
            _logger.info(f"Training Parameters: {params_str}")
    elif message_type == "warning":
        _logger.warning(str(message))
    else:
        _logger.info(str(message))
