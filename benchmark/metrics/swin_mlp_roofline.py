"""The fused MLP kernel's share of its roofline (``csrc/swin_mlp.cu`` in
the port): SwinIR's served forward runs it once a Swin block for the MLP
half (LayerNorm, fc1, GELU, fc2 and the residual add), num_blocks * depth
launches a forward (36 published). The bound is the larger of a row's
operations (fc1 and fc2, 4 * C * hidden) over the bf16 peak and its bytes
(its C channels read once and written once) over the card's bandwidth,
operations binding, summed over the trace's launches, over their summed
time in the trace. C and the hidden are the unpadded work; the kernel's
padded rows and weights do more, so the share stays below 100%.

Each launch's rows come from the port's span of that launch, which counts
them: as ``wattn_roofline`` pairs W's launches, the trace's n launches are
the first n launch spans of the window. None where the trace holds no
launch of the kernel (a program without it) or fewer launch spans than
launches."""

from benchmark import counts, spans

# the kernel's name in the trace, and the port's span of each launch
KERNEL = "swin_mlp_kernel"
SPAN = "kernel.swin_mlp"


def flops_per_row(c: int, hidden: int) -> int:
    """Operations of one row: fc1 and fc2, C * hidden multiply-adds
    each."""
    return 4 * c * hidden


def bytes_per_row(c: int, elem_bytes: int = 2) -> int:
    """Bytes one row must move: its C channels read once and written
    once."""
    return 2 * c * elem_bytes


def read(r):
    n, t = r["trace"].summed(lambda k: KERNEL in k)
    recs = None if n == 0 or t <= 0 else spans.window_records(r)
    if recs is None:
        return None
    made = sorted((s for s in recs if s.name == SPAN),
                  key=lambda s: s.start_ns)
    if len(made) < n:
        return None
    rows = sum(s.count for s in made[:n])
    cfg = r["config"]
    c = cfg["base_filters"]
    hidden = int(c * cfg["mlp_ratio"])
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    bound = max(rows * flops_per_row(c, hidden) / counts.PEAK_BF16_FLOPS,
                rows * bytes_per_row(c, elem) / counts.PEAK_HBM_BYTES_PER_S)
    return 100.0 * bound / t
