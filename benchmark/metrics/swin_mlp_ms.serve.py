"""Device ms a slice in SwinIR's MLP halves (``swin.mlp``: LN2, fc1, the
GELU, fc2 and the residual add), over the window's complete forwards."""

from benchmark.blocks import device_ms_per_slice


def read(r):
    return device_ms_per_slice(r, "swin.mlp")
