from benchmark.readers import untraced


def read(r):
    """The host's mean time in one ``train_step`` call (no synchronise),
    over the steps outside the traced part of the window."""
    units, _ = untraced(r)
    return 1e3 * sum(e - s for s, e, _ in units) / len(units) if units \
        else None
