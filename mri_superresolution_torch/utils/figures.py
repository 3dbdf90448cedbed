"""matplotlib for the figure functions of the CLIs, when it is installed.

The port runs without matplotlib (the card's machine has none). A figure
function asks :func:`pyplot` for the module; without matplotlib it gets
None and skips its figure, with one warning. No number or file other
than a figure depends on matplotlib.
"""

from __future__ import annotations

import logging

_logger = logging.getLogger("mri_superresolution_torch")


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None, with a warning,
    when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        _logger.warning("matplotlib is not installed; a figure is skipped")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt
