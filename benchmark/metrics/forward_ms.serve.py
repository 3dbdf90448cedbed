from benchmark.spans import device_ms_median


def read(r):
    return device_ms_median(r, "engine.forward")
