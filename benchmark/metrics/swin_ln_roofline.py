"""The padded LayerNorm kernel's share of its byte bound
(``csrc/padded_layer_norm.cu`` in the port): SwinIR's served forward keeps
its tokens in rows of C rounded up to 8 channels and runs the kernel for
each LayerNorm, 2 * num_blocks * depth + 2 launches a forward (74
published). The bound counts the unpadded work, each row's C channels read
once and written once (rows * 2 * C * 2 B in bf16) at the card's
bandwidth, summed over the trace's launches, over their summed time in the
trace; the padded rows move more, so the share stays below 100%.

Each launch's rows come from the port's span of that launch, which counts
them: as ``wattn_roofline`` pairs W's launches, the trace's n launches are
the first n launch spans of the window. None where the trace holds no
launch of the kernel (a program without it) or fewer launch spans than
launches."""

from benchmark import counts, spans

# the kernel's name in the trace, and the port's span of each launch
KERNEL = "padded_ln_kernel"
SPAN = "kernel.swin_layer_norm"


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
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    return 100.0 * rows * bytes_per_row(cfg["base_filters"], elem) / \
        counts.PEAK_HBM_BYTES_PER_S / t
