from benchmark.spans import idle_ms_per_volume


def read(r):
    return idle_ms_per_volume(r, "engine")
