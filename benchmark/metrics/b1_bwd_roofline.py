from benchmark import counts
from benchmark.readers import B1_BACKWARD, b1_roofline_pct


def read(r):
    return b1_roofline_pct(r, B1_BACKWARD,
                           counts.b1_backward_bytes_per_slice, r["batch"])
