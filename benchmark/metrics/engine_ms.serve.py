import statistics

from benchmark.readers import untraced


def read(r):
    """The median host time of one volume's pass through the engine's
    ``upscale_batches`` window (page-locked; the first batch dispatched to
    the last result fetched), over the volumes outside the traced part of
    the window: the serving path without the volume's page-lock, drain and
    assembly, and steadier than the whole window's rate."""
    volumes, _ = untraced(dict(r, work=r["volumes"]))
    return 1e3 * statistics.median(b for _, _, b in volumes) if volumes \
        else None
