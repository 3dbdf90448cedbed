def read(r):
    """Device time of the host-to-device and device-to-host copies in the
    trace, over the batches served while it ran."""
    n, s = r["trace"].copy_s()
    if n == 0 or r["batches_traced"] == 0:
        return None
    return 1e3 * s / r["batches_traced"]
