from benchmark import counts
from benchmark.readers import B1_FORWARD, b1_roofline_pct


def read(r):
    return b1_roofline_pct(r, B1_FORWARD, counts.b1_forward_bytes_per_slice,
                           r["slices_per_forward"])
