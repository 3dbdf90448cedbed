from benchmark.spans import host_ms_median


def read(r):
    return host_ms_median(r, "engine.dispatch")
