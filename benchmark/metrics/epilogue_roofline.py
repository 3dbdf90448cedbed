"""The epilogue kernel's share of its byte bound (``csrc/bias_epilogue.cu``
in the port): EDSR's served trunk adds each conv's bias, ReLU, res_scale
and residual in one pass a conv, 2 * num_blocks + 2 launches a forward.
None where the trace holds no launch of it (a program without it)."""

from benchmark import counts

# the kernel's name in the trace
KERNEL = "bias_epilogue_kernel"


def bytes_per_slice(h: int, w: int, c: int, blocks: int,
                    elem_bytes: int = 2) -> int:
    """Bytes the epilogue must move for one (h, w) slice: y read and the
    output written at the head and at each block's first conv (2 tensors
    of c * h * w), y and the residual read and the output written at each
    block's second conv and at the trunk's closing conv (3 tensors):
    5 * blocks + 5 tensors."""
    return (5 * blocks + 5) * c * h * w * elem_bytes


def read(r):
    n, t = r["trace"].summed(lambda k: KERNEL in k)
    if n == 0 or t <= 0:
        return None
    cfg = r["config"]
    blocks = cfg["num_blocks"]
    h, w = r["b1_site_hw"]
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    forwards = n / (2 * blocks + 2)
    bound = forwards * r["slices_per_forward"] * bytes_per_slice(
        h, w, cfg["base_filters"], blocks, elem) / counts.PEAK_HBM_BYTES_PER_S
    return 100.0 * bound / t
