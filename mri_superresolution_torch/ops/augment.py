"""Paired augmentation of HR/LR batches on the batch's device.

An own copy of the JAX package's ``ops/augment.py`` (reference
utils/dataset.py:138-175): hflip p=.5; rotation p=.5 in ±5° with
per-image mean fill (nearest resample); brightness ×U(.9,1.1) p=.3;
contrast ×U(.9,1.1) p=.3; Gaussian noise σ=.01 p=.2 on the LR image only.
HR and LR always receive the same geometric and photometric draws.

The random draws are split from the transforms: :func:`draw_augment`
draws every number a batch needs from a ``torch.Generator``, and
:func:`apply_augment` applies them, so that a test can feed the JAX
package's draws to the port. Images are (B, H, W, C), the JAX layout;
the rotations take one angle and one fill value an image, batched where
the JAX package ``vmap``s.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mri_superresolution_torch.config import AugmentConfig


def rotate(img: torch.Tensor, angle_deg: torch.Tensor, fill: torch.Tensor,
           method: str = "nearest") -> torch.Tensor:
    """Rotate (B, H, W, C) images counterclockwise about their centers by
    ``angle_deg`` (B,), out-of-bounds pixels taking ``fill`` (B,): the
    nearest-neighbour gather of ``ops/augment.rotate`` (torchvision
    TF.rotate's default)."""
    if method != "nearest":
        raise NotImplementedError("rotate: only the nearest method is "
                                  "ported (rotate_shear has both)")
    b, h, w, c = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = angle_deg.float() * math.pi / 180.0
    cos, sin = torch.cos(theta).view(b, 1, 1), torch.sin(theta).view(b, 1, 1)
    yy = torch.arange(h, dtype=torch.float32, device=img.device).view(h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, w)
    # inverse mapping of a counterclockwise rotation in display coords
    sx = cos * (xx - cx) - sin * (yy - cy) + cx
    sy = sin * (xx - cx) + cos * (yy - cy) + cy
    ix, iy = torch.round(sx).long(), torch.round(sy).long()
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)            # (B, H, W)
    vals = torch.gather(img.reshape(b, h * w, c), 1,
                        idx.reshape(b, h * w, 1).expand(b, h * w, c))
    return torch.where(valid[..., None], vals.reshape(b, h, w, c),
                       fill.view(b, 1, 1, 1).to(img.dtype))


def _shift_select(img: torch.Tensor, shifts: torch.Tensor,
                  fill: torch.Tensor, axis: int, k_max: int,
                  method: str) -> torch.Tensor:
    """Per-line fractional shift of (B, H, W, C) images along ``axis`` (1:
    along W, ``shifts`` (B, H); 0: along H, ``shifts`` (B, W)), without a
    gather: a loop over the 2 * k_max + 1 integer shifts of a zero-padded
    copy with per-line masks, then the fill where the shift left the
    image."""
    b, h, w, _ = img.shape
    size, dim = (w, 2) if axis == 1 else (h, 1)
    pad = [0, 0, k_max, k_max] if axis == 1 else [0, 0, 0, 0, k_max, k_max]
    padded = F.pad(img, pad)
    valid = F.pad(torch.ones_like(img), pad)
    if method == "nearest":
        taps = ((torch.round(shifts).int(), None),)
    else:  # linear
        k0 = torch.floor(shifts).int()
        frac = shifts - k0
        taps = ((k0, 1.0 - frac), (k0 + 1, frac))
    mask_shape = (b, -1, 1, 1) if axis == 1 else (b, 1, -1, 1)

    out = torch.zeros_like(img)
    vsum = torch.zeros_like(img)
    for k in range(-k_max, k_max + 1):
        copy = padded.narrow(dim, k_max - k, size)
        vcopy = valid.narrow(dim, k_max - k, size)
        for k_line, weight in taps:
            sel = (k_line == k).reshape(mask_shape).to(img.dtype)
            wgt = sel if weight is None else sel * weight.reshape(mask_shape)
            out = out + wgt * copy
            vsum = vsum + wgt * vcopy
    # out-of-range contributions came from zero padding; blend in the fill
    return out + (1.0 - vsum) * fill.view(b, 1, 1, 1)


def rotate_shear(img: torch.Tensor, angle_deg: torch.Tensor,
                 fill: torch.Tensor, method: str = "nearest",
                 max_angle_deg: float = 6.0) -> torch.Tensor:
    """Paeth 3-shear rotation of (B, H, W, C) images by ``angle_deg``
    (B,), fill ``fill`` (B,): R(θ) = ShearX(-tan θ/2) · ShearY(sin θ) ·
    ShearX(-tan θ/2), each shear a per-line shift (:func:`_shift_select`).
    ``max_angle_deg`` bounds the shift range (must cover |angle|)."""
    b, h, w, _ = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = -angle_deg.float() * math.pi / 180.0  # display coords: ccw
    alpha = (-torch.tan(theta / 2.0)).view(b, 1)
    beta = torch.sin(theta).view(b, 1)

    max_t = math.radians(max_angle_deg)
    k_x = int(math.ceil(abs(math.tan(max_t / 2.0)) * max(h, w) / 2.0)) + 1
    k_y = int(math.ceil(abs(math.sin(max_t)) * max(h, w) / 2.0)) + 1

    rows = torch.arange(h, dtype=torch.float32, device=img.device) - cy
    cols = torch.arange(w, dtype=torch.float32, device=img.device) - cx

    x = _shift_select(img, alpha * rows, fill, axis=1, k_max=k_x,
                      method=method)
    x = _shift_select(x, beta * cols, fill, axis=0, k_max=k_y, method=method)
    return _shift_select(x, alpha * rows, fill, axis=1, k_max=k_x,
                         method=method)


def draw_augment(b: int, lr_shape, cfg: AugmentConfig,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every random number :func:`apply_augment` needs for a batch of
    ``b`` pairs, on the generator's device: uniforms for each decision,
    the angles, the brightness and contrast factors (as uniforms), and a
    standard normal the shape of the LR batch."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    lo, hi = cfg.rotate_range
    return {"u_flip": u(b), "u_rot": u(b), "angle": lo + u(b) * (hi - lo),
            "u_bri": u(b, 2), "u_con": u(b, 2), "u_noise": u(b),
            "noise": torch.randn(tuple(lr_shape), generator=generator,
                                 device=dev)}


def _maybe(flag: torch.Tensor, transformed: torch.Tensor,
           original: torch.Tensor) -> torch.Tensor:
    return torch.where(flag.view((-1,) + (1,) * (original.dim() - 1)),
                       transformed, original)


def apply_augment(hr: torch.Tensor, lr: torch.Tensor,
                  d: Dict[str, torch.Tensor], cfg: AugmentConfig,
                  rotate_method: str = "nearest",
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the draws ``d`` (:func:`draw_augment`) to an HR/LR batch,
    (B, H, W, C) and (B, h, w, C) in [0, 1]; the same decisions and
    factors for both, the noise on LR only."""
    flip = d["u_flip"] < cfg.flip_prob
    hr = _maybe(flip, hr.flip(2), hr)
    lr = _maybe(flip, lr.flip(2), lr)

    # rotation: the same angle, each image filled with its own mean
    do_rot = d["u_rot"] < cfg.rotate_prob
    fill_hr = hr.mean(dim=(1, 2, 3))
    fill_lr = lr.mean(dim=(1, 2, 3))
    max_angle = max(abs(cfg.rotate_range[0]), abs(cfg.rotate_range[1])) + 1.0
    hr = _maybe(do_rot, rotate_shear(hr, d["angle"], fill_hr, rotate_method,
                                     max_angle), hr)
    lr = _maybe(do_rot, rotate_shear(lr, d["angle"], fill_lr, rotate_method,
                                     max_angle), lr)

    # brightness: multiply + clamp (the same factor on both)
    u_bri = d["u_bri"]
    bri = (cfg.brightness_range[0] + u_bri[:, 1] *
           (cfg.brightness_range[1] - cfg.brightness_range[0])).view(-1, 1, 1,
                                                                      1)
    do_bri = u_bri[:, 0] < cfg.brightness_prob
    hr = _maybe(do_bri, (hr * bri).clamp(0, 1), hr)
    lr = _maybe(do_bri, (lr * bri).clamp(0, 1), lr)

    # contrast: (x - mean) * factor + mean, mean per image
    u_con = d["u_con"]
    con = (cfg.contrast_range[0] + u_con[:, 1] *
           (cfg.contrast_range[1] - cfg.contrast_range[0])).view(-1, 1, 1, 1)
    do_con = u_con[:, 0] < cfg.contrast_prob
    mean_hr = hr.mean(dim=(1, 2, 3), keepdim=True)
    mean_lr = lr.mean(dim=(1, 2, 3), keepdim=True)
    hr = _maybe(do_con, ((hr - mean_hr) * con + mean_hr).clamp(0, 1), hr)
    lr = _maybe(do_con, ((lr - mean_lr) * con + mean_lr).clamp(0, 1), lr)

    # Gaussian noise on the LR image only (reference utils/dataset.py:168)
    do_noise = d["u_noise"] < cfg.noise_prob
    lr = _maybe(do_noise, (lr + d["noise"] * cfg.noise_std).clamp(0, 1), lr)
    return hr.contiguous(), lr.contiguous()


def augment_pair(hr: torch.Tensor, lr: torch.Tensor,
                 generator: torch.Generator, cfg: AugmentConfig,
                 rotate_method: str = "nearest", rows=None,
                 global_batch: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Identical per-sample augmentation of an HR/LR batch, drawn from
    ``generator`` (on the batch's device). With ``rows`` the batch holds
    those rows of a global batch of ``global_batch`` pairs (a
    data-parallel rank's): the draws are made for the global batch, as a
    single process makes them, and the rows' draws applied."""
    if rows is None:
        return apply_augment(hr, lr, draw_augment(hr.shape[0], lr.shape,
                                                  cfg, generator),
                             cfg, rotate_method)
    d = draw_augment(global_batch, (global_batch,) + tuple(lr.shape[1:]),
                     cfg, generator)
    idx = torch.as_tensor(rows, dtype=torch.long, device=generator.device)
    return apply_augment(hr, lr, {k: v[idx] for k, v in d.items()}, cfg,
                         rotate_method)
