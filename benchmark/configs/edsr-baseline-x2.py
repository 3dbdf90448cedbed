"""Plain fp32 reference of ``edsr-baseline-x2``: EDSR-baseline (Lim et
al. 2017, arXiv:1707.02921, Table 1) as its configuration file states it:
a 3x3 head conv, 16 residual blocks (conv3x3 -> ReLU -> conv3x3, added to
the block's input with res_scale 1.0), a closing 3x3 conv, the global skip
from the head, a 3x3 tail to 4 channels, PixelShuffle(2) and a sigmoid.
Every conv has a bias."""

import math

import torch
import torch.nn.functional as F

from benchmark import counts
from benchmark.reference import conv


def _conv_spec(name, cout, cin):
    std = math.sqrt(1.0 / (3.0 * cin * 9))
    return [(f"{name}.weight", (cout, cin, 3, 3), 0.0, std),
            (f"{name}.bias", (cout,), 0.0, std)]


def param_spec(cfg):
    f, s = cfg["base_filters"], cfg["scale"]
    spec = _conv_spec("head", f, cfg["in_channels"])
    for i in range(cfg["num_blocks"]):
        spec += _conv_spec(f"block{i}.conv0", f, f)
        spec += _conv_spec(f"block{i}.conv1", f, f)
    spec += _conv_spec("body_out", f, f)
    spec += _conv_spec("tail", cfg["out_channels"] * s * s, f)
    return spec


def flops_per_slice(cfg, h, w):
    return counts.edsr_flops_per_slice(h, w, cfg["base_filters"],
                                       cfg["num_blocks"], cfg["scale"])


def forward(p, x, precision="fp32", num_blocks=None, res_scale=1.0):
    """(n, h, w, 1) in [0, 1] -> (n, 2h, 2w, 1) in (0, 1), fp32."""
    def c(t, name):
        return conv(t, p[f"{name}.weight"], p[f"{name}.bias"], 1, precision)

    blocks = num_blocks if num_blocks is not None else sum(
        1 for k in p if k.endswith(".conv0.weight"))
    head = c(x.permute(0, 3, 1, 2).float(), "head")
    y = head
    for i in range(blocks):
        y = y + res_scale * c(F.relu(c(y, f"block{i}.conv0")),
                              f"block{i}.conv1")
    y = c(c(y, "body_out") + head, "tail")
    return torch.sigmoid(F.pixel_shuffle(y, 2)).permute(0, 2, 3, 1)
