from benchmark.readers import mfu_pct


def read(r):
    return mfu_pct(r)
