"""Whole-window statistics."""

from __future__ import annotations


def rate(count: float, seconds: float) -> float:
    """Work over the whole window: ``count`` units in ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds

