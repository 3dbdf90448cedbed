"""Arithmetic the per-layer metrics' readers share. A reader takes the
run's reading (the cell's counts, the configuration, the device trace)
and returns its number, or None where the run gave it nothing to read."""

from __future__ import annotations

from benchmark import counts

# (every kernel of a launch, the one kernel each launch runs once) of
# B1's routes: the one-pass kernel, or the multi-pass route's kernels
B1_FORWARD = (("gn_onepass_kernel", "gn_stats_kernel", "gn_apply_kernel"),
              ("gn_onepass_kernel", "gn_apply_kernel"))
B1_BACKWARD = (("gn_onepass_bwd_kernel", "gnb_stats", "gnb_partial",
                "gnb_reduce", "gnb_apply"),
               ("gn_onepass_bwd_kernel", "gnb_apply"))


def idle_pct(r):
    share = r["trace"].idle_share()
    return None if share is None else 100.0 * share


def untraced(r):
    """The window's work outside its traced part, and that part's seconds:
    (the ``(start, end, slices)`` units of ``r["work"]`` that ended before
    the profiler started or began after it had stopped, seconds). The
    profiler's start, tracing and stop slow the host, so a reading of the
    host's clock over the whole window would measure the tracer."""
    t0, t_end = r["t0"], r["t_end"]
    lo, hi = r["traced"] or (t_end, t_end)
    units = [u for u in r["work"] if u[1] <= lo or u[0] >= hi]
    return units, (lo - t0) + (t_end - hi)


def mfu_pct(r, passes: int = 1):
    """Architecture FLOPs of every slice of the untraced window
    (``passes`` times the forward's: 3 for a training step) over its
    seconds, as a share of the card's bf16 peak."""
    units, seconds = untraced(r)
    if not units or seconds <= 0:
        return None
    flops = passes * r["flops_per_slice"] * sum(n for _, _, n in units)
    return 100.0 * flops / seconds / counts.PEAK_BF16_FLOPS


def b1_roofline_pct(r, names, bytes_per_slice, slices_per_pass):
    """The byte bound of the B1 launches in the trace over their summed
    time. ``names`` is (the kernels whose time counts, the kernels of
    which a launch runs one); the passes (forwards or steps) are the
    launches over the U-Net's site count."""
    timed, once = names
    _, t = r["trace"].summed(lambda k: any(s in k for s in timed))
    n, _ = r["trace"].summed(lambda k: any(s in k for s in once))
    if n == 0 or t <= 0:
        return None
    h, w = r["b1_site_hw"]
    f = r["config"]["base_filters"]
    passes = n / len(counts.unet_b1_sites(h, w, f))
    bound = passes * slices_per_pass * bytes_per_slice(h, w, f) \
        / counts.PEAK_HBM_BYTES_PER_S
    return 100.0 * bound / t
