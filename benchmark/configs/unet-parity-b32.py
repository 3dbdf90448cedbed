"""Plain fp32 reference of ``unet-parity-b32``: the parity UNetSuperRes
(rdd0582/mri_superresolution, models/unet_model.py:116-211) written out
from the published module, with the reference's state_dict names.

DoubleConv = (conv3x3 -> GroupNorm(8) -> LeakyReLU(0.2)) x 2, plus the
input when the channel count is kept; Down = maxpool 2 then DoubleConv;
Up = bilinear 2x (aligned corners), 1x1 conv halving the channels,
GroupNorm + LeakyReLU, zero pad to the skip, concat [skip, up],
DoubleConv; the final 2x stage fuses a bilinear branch (upsample, conv3x3,
GroupNorm + LeakyReLU) with a PixelShuffle branch (conv3x3 with bias,
PixelShuffle(2), GroupNorm + LeakyReLU) by sigmoid(alpha), then conv3x3,
GroupNorm + LeakyReLU, a 1x1 conv with bias and a sigmoid.
"""

import math

import torch
import torch.nn.functional as F

from benchmark import counts
from benchmark.reference import conv, gn_leaky, upsample2


def _conv_spec(name, cout, cin, k, bias=False):
    out = [(f"{name}.weight", (cout, cin, k, k), 0.0,
            math.sqrt(2.0 / (cin * k * k)))]
    if bias:
        out.append((f"{name}.bias", (cout,), 0.0, 0.1))
    return out


def _norm_spec(name, c):
    return [(f"{name}.weight", (c,), 1.0, 0.1), (f"{name}.bias", (c,), 0.0,
                                                  0.1)]


def _double(prefix, cin, cout):
    return (_conv_spec(f"{prefix}.0", cout, cin, 3)
            + _norm_spec(f"{prefix}.1", cout)
            + _conv_spec(f"{prefix}.3", cout, cout, 3)
            + _norm_spec(f"{prefix}.4", cout))


def param_spec(cfg):
    f = cfg["base_filters"]
    spec = [("alpha", (1,), cfg["initial_alpha"] / 100.0, 0.5)]
    spec += _double("inc.double_conv", cfg["in_channels"], f)
    for i, (a, b) in enumerate([(f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f)]):
        spec += _double(f"down{i + 1}.maxpool_conv.1.double_conv", a, b)
    for i, c in enumerate([8 * f, 4 * f, 2 * f]):
        spec += _conv_spec(f"up{i + 1}.up.1", c // 2, c, 1)
        spec += _norm_spec(f"up{i + 1}.up.2", c // 2)
        spec += _double(f"up{i + 1}.conv.double_conv", c, c // 2)
    spec += _conv_spec("final_up_bilinear.1", f // 2, f, 3)
    spec += _norm_spec("final_up_bilinear.2", f // 2)
    spec += _conv_spec("final_up_pixelshuffle.conv", 2 * f, f, 3, bias=True)
    spec += _norm_spec("final_up_pixelshuffle.norm", f // 2)
    spec += _conv_spec("final_conv.0", f // 2, f // 2, 3)
    spec += _norm_spec("final_conv.1", f // 2)
    spec += _conv_spec("final_conv.3", cfg["out_channels"], f // 2, 1,
                       bias=True)
    return spec


def flops_per_slice(cfg, h, w):
    return counts.unet_flops_per_slice(h, w, cfg["base_filters"])


def forward(p, x, precision="fp32"):
    """(n, h, w, 1) in [0, 1] -> (n, 2h, 2w, 1) in (0, 1), fp32."""
    def c(t, name, padding=1, bias=False):
        return conv(t, p[f"{name}.weight"], p[f"{name}.bias"] if bias
                    else None, padding, precision)

    def n(t, name):
        return gn_leaky(t, p[f"{name}.weight"], p[f"{name}.bias"])

    def double(t, prefix):
        y = n(c(t, f"{prefix}.0"), f"{prefix}.1")
        y = n(c(y, f"{prefix}.3"), f"{prefix}.4")
        return y + t if y.shape[1] == t.shape[1] else y

    def up(t, skip, i):
        t = n(c(upsample2(t), f"up{i}.up.1", padding=0), f"up{i}.up.2")
        dy, dx = skip.shape[2] - t.shape[2], skip.shape[3] - t.shape[3]
        t = F.pad(t, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return double(torch.cat([skip, t], dim=1), f"up{i}.conv.double_conv")

    t = x.permute(0, 3, 1, 2).float()
    x1 = double(t, "inc.double_conv")
    x2 = double(F.max_pool2d(x1, 2), "down1.maxpool_conv.1.double_conv")
    x3 = double(F.max_pool2d(x2, 2), "down2.maxpool_conv.1.double_conv")
    x4 = double(F.max_pool2d(x3, 2), "down3.maxpool_conv.1.double_conv")
    y = up(up(up(x4, x3, 1), x2, 2), x1, 3)
    yb = n(c(upsample2(y), "final_up_bilinear.1"), "final_up_bilinear.2")
    yp = n(F.pixel_shuffle(c(y, "final_up_pixelshuffle.conv", bias=True), 2),
           "final_up_pixelshuffle.norm")
    a = torch.sigmoid(p["alpha"]).view(())
    y = a * yb + (1.0 - a) * yp
    y = n(c(y, "final_conv.0"), "final_conv.1")
    y = c(y, "final_conv.3", padding=0, bias=True)
    return torch.sigmoid(y).permute(0, 2, 3, 1)
