from benchmark.spans import phase_ms_per_step


def read(r):
    return phase_ms_per_step(r, "backward")
