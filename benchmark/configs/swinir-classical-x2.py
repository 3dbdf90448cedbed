"""Plain fp32 reference of ``swinir-classical-x2``: SwinIR's classical 2x
network (Liang et al. 2021, arXiv:2108.10257) as the published
``models/network_swinir.py`` computes it with the settings of
``main_test_swinir.py --task classical_sr --scale 2`` (``upsampler
"pixelshuffle"``, ``resi_connection "1conv"``, no absolute position
embedding, LayerNorm after the patch embedding, qkv bias, ``img_range`` 1)
at one channel, mean 0: a reflect pad to a multiple of the window, a head
conv, ``num_blocks`` residual Swin groups of ``depth`` blocks (LN, window
attention with the relative-position bias and, on every odd block, the
published roll by -window/2 and ``calculate_mask``, the roll back; LN, a
GELU MLP), a conv after each group and after the trunk, the global skip,
conv + LeakyReLU(0.01), conv + PixelShuffle(2), the last conv, the crop.

Every attention of every window is materialized, so a call runs in blocks
of :data:`BLOCK` slices. ``precision="fp8"`` rounds every linear's and
conv's input and weight (``reference.rounded``); the attention products
stay in fp32."""

import torch
import torch.nn.functional as F

from benchmark.reference import rounded

# slices a block of the forward: the materialized scores of 8 slices at
# 256^2 take 0.8 GB a block
BLOCK = 8


def _lin(name, cout, cin, std, bias_std):
    return [(f"{name}.weight", (cout, cin), 0.0, std),
            (f"{name}.bias", (cout,), 0.0, bias_std)]


def _conv(name, cout, cin, std, bias_mean, bias_std):
    return [(f"{name}.weight", (cout, cin, 3, 3), 0.0, std),
            (f"{name}.bias", (cout,), bias_mean, bias_std)]


def _ln(name, c):
    return [(f"{name}.weight", (c,), 1.0, 0.1), (f"{name}.bias", (c,), 0.0,
                                                 0.1)]


def param_spec(cfg):
    """(name, shape, mean, std) of every tensor, the published names. The
    draws keep each part working (the config's ``assumed``): LN scales 1 +
    N(0, 0.1); qkv N(0, 0.08), so that a head's logits have a std of
    about 180 * 0.08^2 = 1.15; the bias table N(0, 1); proj, fc2 and the
    groups' convs at half the variance-keeping std; conv_last's bias 0.5 +
    N(0, 0.01) and weights N(0, 0.008), outputs about 0.5 +- 0.13."""
    c, f = cfg["base_filters"], cfg["num_feat"]
    hid = int(c * cfg["mlp_ratio"])
    tab = (2 * cfg["window_size"] - 1) ** 2
    spec = _conv("conv_first", c, cfg["in_channels"], 1 / 3, 0.0, 0.1)
    spec += _ln("patch_embed.norm", c)
    for i in range(cfg["num_blocks"]):
        for j in range(cfg["depth"]):
            b = f"layers.{i}.residual_group.blocks.{j}"
            spec += _ln(f"{b}.norm1", c)
            spec += [(f"{b}.attn.relative_position_bias_table",
                      (tab, cfg["num_heads"]), 0.0, 1.0)]
            spec += _lin(f"{b}.attn.qkv", 3 * c, c, 0.08, 0.05)
            spec += _lin(f"{b}.attn.proj", c, c, 0.5 * c ** -0.5, 0.02)
            spec += _ln(f"{b}.norm2", c)
            spec += _lin(f"{b}.mlp.fc1", hid, c, c ** -0.5, 0.1)
            spec += _lin(f"{b}.mlp.fc2", c, hid, 0.5 * hid ** -0.5, 0.02)
        spec += _conv(f"layers.{i}.conv", c, c, 0.5 * (9 * c) ** -0.5, 0.0,
                      0.02)
    spec += _ln("norm", c)
    spec += _conv("conv_after_body", c, c, (9 * c) ** -0.5, 0.0, 0.02)
    spec += _conv("conv_before_upsample.0", f, c, (9 * c) ** -0.5, 0.0, 0.1)
    spec += _conv("upsample.0", 4 * f, f, (9 * f) ** -0.5, 0.0, 0.05)
    spec += _conv("conv_last", cfg["out_channels"], f, 0.008, 0.5, 0.01)
    return spec


def flops_per_slice(cfg, h, w):
    """2 x the multiply-adds of every linear, conv and attention matmul
    (q k^T and P v) for one (h, w) slice, at its size padded to the
    window; conv_last at 2h x 2w."""
    ws = cfg["window_size"]
    px = (-(-h // ws) * ws) * (-(-w // ws) * ws)
    c, f, n = cfg["base_filters"], cfg["num_feat"], ws * ws
    hid = int(c * cfg["mlp_ratio"])
    block = 2 * (3 * c * c + 2 * n * c + c * c + 2 * c * hid)
    per_px = 2 * 9 * cfg["in_channels"] * c
    per_px += cfg["num_blocks"] * (cfg["depth"] * block + 2 * 9 * c * c)
    per_px += 2 * 9 * c * c + 2 * 9 * c * f + 2 * 9 * f * 4 * f
    per_px += 4 * 2 * 9 * f * cfg["out_channels"]
    return px * per_px


def _window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def _window_reverse(windows, ws, h, w):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def _relative_position_index(ws):
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _calculate_mask(h, w, ws, shift):
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = _window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(
        mask == 0, float(0.0))


def _forward(p, x, cfg, precision):
    def lin(t, name):
        return F.linear(rounded(t, precision),
                        rounded(p[f"{name}.weight"], precision),
                        p[f"{name}.bias"])

    def conv(t, name):
        return F.conv2d(rounded(t, precision),
                        rounded(p[f"{name}.weight"], precision),
                        p[f"{name}.bias"], padding=1)

    def ln(t, name):
        return F.layer_norm(t, t.shape[-1:], p[f"{name}.weight"],
                            p[f"{name}.bias"], 1e-5)

    ws, heads = cfg["window_size"], cfg["num_heads"]
    x = x.permute(0, 3, 1, 2).float()
    h0, w0 = x.shape[2:]
    x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws), "reflect")
    h, w = x.shape[2:]
    rel = _relative_position_index(ws).view(-1).to(x.device)
    mask = _calculate_mask(h, w, ws, ws // 2).to(x.device)
    feat = conv(x, "conv_first")
    b, c = feat.shape[:2]
    n, hd = ws * ws, c // heads
    t = ln(feat.flatten(2).transpose(1, 2), "patch_embed.norm")
    for i in range(cfg["num_blocks"]):
        y = t
        for j in range(cfg["depth"]):
            pre = f"layers.{i}.residual_group.blocks.{j}"
            shift = 0 if j % 2 == 0 else ws // 2
            s = ln(y, f"{pre}.norm1").view(b, h, w, c)
            if shift:
                s = torch.roll(s, shifts=(-shift, -shift), dims=(1, 2))
            s = _window_partition(s, ws).view(-1, n, c)
            qkv = lin(s, f"{pre}.attn.qkv").reshape(-1, n, 3, heads, hd) \
                .permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
            attn = q @ k.transpose(-2, -1)
            bias = p[f"{pre}.attn.relative_position_bias_table"][rel] \
                .view(n, n, -1).permute(2, 0, 1).contiguous()
            attn = attn + bias.unsqueeze(0)
            if shift:
                nw = mask.shape[0]
                attn = (attn.view(-1, nw, heads, n, n) +
                        mask.unsqueeze(1).unsqueeze(0)).view(-1, heads, n, n)
            attn = torch.softmax(attn, dim=-1)
            s = lin((attn @ v).transpose(1, 2).reshape(-1, n, c),
                    f"{pre}.attn.proj")
            s = _window_reverse(s.view(-1, ws, ws, c), ws, h, w)
            if shift:
                s = torch.roll(s, shifts=(shift, shift), dims=(1, 2))
            y = y + s.reshape(b, h * w, c)
            y = y + lin(F.gelu(lin(ln(y, f"{pre}.norm2"), f"{pre}.mlp.fc1")),
                        f"{pre}.mlp.fc2")
        y = conv(y.transpose(1, 2).reshape(b, c, h, w), f"layers.{i}.conv")
        t = y.flatten(2).transpose(1, 2) + t
    t = ln(t, "norm").transpose(1, 2).reshape(b, c, h, w)
    y = conv(t, "conv_after_body") + feat
    y = F.leaky_relu(conv(y, "conv_before_upsample.0"), 0.01)
    y = F.pixel_shuffle(conv(y, "upsample.0"), 2)
    y = conv(y, "conv_last")
    return y[:, :, :2 * h0, :2 * w0].permute(0, 2, 3, 1)


def forward(p, x, precision="fp32", cfg=None):
    """(n, h, w, 1) in [0, 1] -> (n, 2h, 2w, 1), fp32, unbounded; in
    blocks of :data:`BLOCK` slices. The widths come from ``cfg``, or from
    the params' shapes (the harness passes none)."""
    cfg = cfg or widths(p)
    return torch.cat([_forward(p, x[i:i + BLOCK], cfg, precision)
                      for i in range(0, x.shape[0], BLOCK)])


def widths(p):
    """The configuration's widths as the params' shapes give them."""
    pre = "layers.0.residual_group.blocks"
    table = p[f"{pre}.0.attn.relative_position_bias_table"]
    c = p["conv_first.weight"].shape[0]
    return {"base_filters": c,
            "num_blocks": len({k.split(".")[1] for k in p
                               if k.startswith("layers.")}),
            "depth": len({k.split(".")[4] for k in p
                          if k.startswith(pre + ".")}),
            "num_heads": table.shape[1],
            "window_size": (round(table.shape[0] ** 0.5) + 1) // 2}
