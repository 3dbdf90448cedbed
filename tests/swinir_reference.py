"""Plain fp32 reference of SwinIR's classical-SR network (Liang et al.
2021, arXiv:2108.10257), written from the published
``models/network_swinir.py`` with ``upsampler="pixelshuffle"``,
``resi_connection="1conv"``, ``ape=False``, ``patch_norm=True``,
``img_range=1`` and mean 0 at one channel: the published roll, window
partition, ``calculate_mask`` slices and ``relative_position_index``
construction, each block's attention materialized. It imports nothing of
either package of this repository, and takes a state_dict under the
published names (without the two buffers).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws):
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def calculate_mask(h, w, ws, shift):
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(
        mask == 0, float(0.0))


def linear(x, p, name, rnd=lambda t: t):
    return F.linear(rnd(x), rnd(p[f"{name}.weight"]), p[f"{name}.bias"])


def conv(x, p, name, rnd=lambda t: t):
    return F.conv2d(rnd(x), rnd(p[f"{name}.weight"]), p[f"{name}.bias"],
                    padding=1)


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], 1e-5)


def window_attention(x, p, pre, heads, ws, mask, rnd=lambda t: t):
    """The published ``WindowAttention.forward`` on (nW * B, N, C)."""
    b_, n, c = x.shape
    hd = c // heads
    qkv = linear(x, p, f"{pre}.qkv", rnd).reshape(b_, n, 3, heads, hd) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * hd ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = p[f"{pre}.relative_position_bias_table"]
    bias = table[relative_position_index(ws).view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + \
            mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
    return linear(x, p, f"{pre}.proj", rnd)


def attention_from_qkv(qkv, table, heads, ws, shift):
    """The published roll, partition, attention (bias, mask, softmax) and
    reverse of a (B, H, W, 3C) qkv, proj left out: (B, H, W, C)."""
    b, h, w, c3 = qkv.shape
    c, n = c3 // 3, ws * ws
    hd = c // heads
    if shift > 0:
        qkv = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
    t = window_partition(qkv, ws).view(-1, n, 3, heads, hd) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = t[0] * hd ** -0.5, t[1], t[2]
    attn = q @ k.transpose(-2, -1)
    bias = table[relative_position_index(ws).view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
    if shift > 0:
        mask = calculate_mask(h, w, ws, shift)
        nw = mask.shape[0]
        attn = (attn.view(b, nw, heads, n, n) + mask.unsqueeze(1)
                .unsqueeze(0)).view(-1, heads, n, n)
    x = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(-1, n, c)
    x = window_reverse(x.view(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x


def swin_block(x, p, pre, hw, heads, ws, shift, rnd=lambda t: t):
    h, w = hw
    b, _, c = x.shape
    shortcut = x
    x = layer_norm(x, p, f"{pre}.norm1").view(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    xw = window_partition(x, ws).view(-1, ws * ws, c)
    mask = calculate_mask(h, w, ws, shift).to(x.device) if shift else None
    aw = window_attention(xw, p, f"{pre}.attn", heads, ws, mask, rnd)
    x = window_reverse(aw.view(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(b, h * w, c)
    y = F.gelu(linear(layer_norm(x, p, f"{pre}.norm2"), p, f"{pre}.mlp.fc1",
                      rnd))
    return x + linear(y, p, f"{pre}.mlp.fc2", rnd)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            rnd=lambda t: t) -> torch.Tensor:
    """(n, h, w, 1) -> (n, 2h, 2w, 1), fp32. ``cfg``: ``embed_dim``,
    ``layers`` (RSTBs), ``depth``, ``heads``, ``window``. ``rnd`` rounds
    every linear's and conv's input and weight (the identity in fp32)."""
    ws, heads = cfg["window"], cfg["heads"]
    x = x.permute(0, 3, 1, 2).float()
    h0, w0 = x.shape[2:]
    x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws), "reflect")
    h, w = x.shape[2:]
    f = conv(x, p, "conv_first", rnd)
    b, c = f.shape[:2]
    t = layer_norm(f.flatten(2).transpose(1, 2), p, "patch_embed.norm")
    for i in range(cfg["layers"]):
        y = t
        for j in range(cfg["depth"]):
            y = swin_block(y, p, f"layers.{i}.residual_group.blocks.{j}",
                           (h, w), heads, ws, 0 if j % 2 == 0 else ws // 2,
                           rnd)
        y = conv(y.transpose(1, 2).view(b, c, h, w), p, f"layers.{i}.conv",
                 rnd)
        t = y.flatten(2).transpose(1, 2) + t
    t = layer_norm(t, p, "norm").transpose(1, 2).view(b, c, h, w)
    y = conv(t, p, "conv_after_body", rnd) + f
    y = F.leaky_relu(conv(y, p, "conv_before_upsample.0", rnd), 0.01)
    y = F.pixel_shuffle(conv(y, p, "upsample.0", rnd), 2)
    y = conv(y, p, "conv_last", rnd)
    return y[:, :, :2 * h0, :2 * w0].permute(0, 2, 3, 1)


def gaussian_ssim(a, b, window=11, sigma=1.5):
    """(n,) SSIM of (n, h, w) images: zero-padded Gaussian window, C1 =
    0.01^2, C2 = 0.03^2, the map's mean."""
    c = torch.arange(window, dtype=torch.float64) - window // 2
    g = torch.exp(-(c * c) / (2 * sigma * sigma))
    g = (g / g.sum()).float()
    w2 = (g[:, None] * g[None, :]).view(1, 1, window, window)
    x = torch.stack([a, b, a * a, b * b, a * b], 1).flatten(0, 1)[:, None]
    m = F.conv2d(x, w2, padding=window // 2).view(a.shape[0], 5,
                                                  *a.shape[1:])
    mu1, mu2, e11, e22, e12 = m.unbind(1)
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return smap.mean(dim=(1, 2))


def l1_ssim_loss(out, hr, ssim_weight=0.3):
    """(1 - w) mean |out - hr| + w (1 - clip(mean SSIM, 0, 1))."""
    l1 = (out - hr).abs().mean()
    s = gaussian_ssim(out[..., 0], hr[..., 0]).mean().clamp(0.0, 1.0)
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - s)


def flops_per_pixel(cfg: dict, num_feat: int, mlp_ratio: float = 2.0) -> int:
    """2 x the multiply-adds of every linear, conv and attention matmul a
    low-resolution pixel (one channel in and out, 2x)."""
    c, n = cfg["embed_dim"], cfg["window"] ** 2
    hidden = int(c * mlp_ratio)
    block = 2 * (c * 3 * c + 2 * n * c + c * c + 2 * c * hidden)
    total = 2 * 9 * c + cfg["layers"] * (cfg["depth"] * block + 2 * 9 * c * c)
    total += 2 * 9 * c * c + 2 * 9 * c * num_feat
    total += 2 * 9 * num_feat * 4 * num_feat + 4 * 2 * 9 * num_feat
    return total

