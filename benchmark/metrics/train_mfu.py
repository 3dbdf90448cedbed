from benchmark.readers import mfu_pct


def read(r):
    """A step is the forward, and a backward of twice its FLOPs."""
    return mfu_pct(r, passes=3)
