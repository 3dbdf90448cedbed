"""The window-attention kernel's share of its roofline
(``csrc/window_attention.cu`` in the port): SwinIR's served forward runs
it once a Swin block, num_blocks * depth launches (36 published). The
bound is the larger of a launch's bytes over the card's bandwidth and its
operations over the bf16 peak (bytes bind), for the slices it took,
summed over the trace's launches, over their summed time in the trace.

The forwards alternate between 64 and 32 slices, and a trace of a few
seconds holds only a few of them, so each launch's slices come from the
port's span of that launch, which counts them. The profiler records only
kernels launched while it runs, the port keeps its spans over the same
time, and one stream runs its launches in the order the host made them:
the trace's n launches are the first n launch spans of the window. None
where the trace holds no launch of the kernel (a program without it) or
fewer launch spans than launches."""

from benchmark import counts, spans

# the kernel's name in the trace, and the port's span of each launch
KERNEL = "window_attention_kernel"
SPAN = "kernel.window_attention"


def bytes_per_slice(h: int, w: int, c: int, elem_bytes: int = 2) -> int:
    """Bytes one launch must move for one (h, w) slice: qkv read once (3C
    a token) and the output written once (C)."""
    return h * w * 4 * c * elem_bytes


def flops_per_slice(h: int, w: int, c: int, window: int = 8) -> int:
    """Operations of one launch for one (h, w) slice: q k^T and P v, 2 N C
    multiply-adds a token each (N = window^2)."""
    return 4 * h * w * window * window * c


def traced_slices(r, n: int):
    """The slices of the trace's ``n`` launches, or None."""
    recs = spans.window_records(r)
    if recs is None:
        return None
    made = sorted((s for s in recs if s.name == SPAN),
                  key=lambda s: s.start_ns)
    if len(made) < n:
        return None
    return sum(s.count for s in made[:n])


def read(r):
    n, t = r["trace"].summed(lambda k: KERNEL in k)
    slices = None if n == 0 or t <= 0 else traced_slices(r, n)
    if not slices:
        return None
    cfg = r["config"]
    h, w = r["b1_site_hw"]
    c, ws = cfg["base_filters"], cfg["window_size"]
    h, w = -(-h // ws) * ws, -(-w // ws) * ws
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    bound = slices * max(
        bytes_per_slice(h, w, c, elem) / counts.PEAK_HBM_BYTES_PER_S,
        flops_per_slice(h, w, c, ws) / counts.PEAK_BF16_FLOPS)
    return 100.0 * bound / t
