"""Device ms a slice in SwinIR's attention halves (``swin.attn``: LN1, the
qkv linear, the window-attention kernel, proj and the residual add), over
the window's complete forwards."""

from benchmark.blocks import device_ms_per_slice


def read(r):
    return device_ms_per_slice(r, "swin.attn")
