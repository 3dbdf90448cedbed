"""The one generator of every traffic mix: inputs from a seed.

A mix is a JSON file under ``benchmark/traffic/`` whose ``kind`` names the
loop that drives it (``benchmark/kinds/<kind>.py``) and whose other keys
are that loop's parameters. Everything drawn here comes from ``--seed``:

- phantom slices: smooth ellipses (six a slice, like the repository's
  ``utils/phantom.py``) evaluated on the device in one batched call, so a
  volume pool costs milliseconds;
- the int16 voxels a scanner stores: phantom intensity times a gain, with
  Gaussian noise, in the NIfTI layout that ``--serve_raw`` reads (a C-order
  (n, w, h) array is the F-order (h, w, n) volume);
- training pairs: the HR phantom, and its LR made by the extraction's
  degradation (centred k-space crop, complex Gaussian noise, magnitude,
  min-max back to the slice's range, 2x area downsample).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The traffic mix ``benchmark/traffic/<name>.json``."""
    path = ROOT / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {path}")
    return json.loads(path.read_text())


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one purpose (``tags``) of ``seed``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def torch_generator(seed: int, device, *tags: int):
    """A ``torch.Generator`` on ``device`` for one purpose of ``seed``."""
    import torch
    s = int(np.random.SeedSequence([int(seed), *tags]).generate_state(
        2, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def phantoms(seed: int, tag: int, n: int, h: int, w: int, device):
    """(n, h, w) fp32 phantoms in [0, 1] on ``device``: six ellipses a
    slice, centres, radii and intensities drawn from (seed, tag)."""
    import torch
    r = rng(seed, 1, tag)
    cy, cx = r.uniform(-0.3, 0.3, (2, n, 6, 1, 1))
    ry, rx = r.uniform(0.05, 0.35, (2, n, 6, 1, 1))
    amp = r.uniform(0.1, 0.5, (n, 6, 1, 1))
    p = torch.from_numpy(np.stack([cy, cx, ry, rx, amp]).astype(np.float32)
                         ).to(device)
    yy = (torch.arange(h, device=device, dtype=torch.float32) / h - 0.5
          ).view(1, 1, h, 1)
    xx = (torch.arange(w, device=device, dtype=torch.float32) / w - 0.5
          ).view(1, 1, 1, w)
    inside = ((yy - p[0]) / p[2]) ** 2 + ((xx - p[1]) / p[3]) ** 2 < 1.0
    return (p[4] * inside).sum(dim=1).clamp(0.0, 1.0)


def stored_int16(seed: int, tag: int, n: int, h: int, w: int, gain: float,
                 noise: float, device) -> np.ndarray:
    """(n, w, h) int16 voxels, C-contiguous on the host: the F-order
    (h, w, n) volume a scanner writes, phantom * gain + N(0, noise)."""
    import torch
    x = phantoms(seed, tag, n, h, w, device) * gain
    g = torch_generator(seed, device, 2, tag)
    x = x + noise * torch.randn(x.shape, generator=g, device=device)
    x = x.round().clamp(-32768, 32767).to(torch.int16)
    return np.ascontiguousarray(x.transpose(1, 2).cpu().numpy())


def degrade(hr, seed: int, tag: int, crop: float, noise_std: float):
    """The LR of (n, H, W) fp32 HR slices: the extraction's k-space
    simulation (a centred rectangle of ``crop`` of each axis kept, complex
    noise of std ``(noise_std / 255) * sqrt(H * W) / 10`` added, the
    magnitude min-max rescaled to each slice's range), then a 2x area
    downsample, as fp32 in [0, 1]."""
    import torch
    import torch.nn.functional as F
    n, rows, cols = hr.shape
    lo0 = hr.amin(dim=(1, 2), keepdim=True)
    hi0 = hr.amax(dim=(1, 2), keepdim=True)
    k = torch.fft.fftshift(torch.fft.fft2(hr), dim=(1, 2))
    mask = torch.zeros(rows, cols, device=hr.device)
    cr, cc = int(rows * crop) // 2, int(cols * crop) // 2
    mask[rows // 2 - cr:rows // 2 + cr, cols // 2 - cc:cols // 2 + cc] = 1.0
    g = torch_generator(seed, hr.device, 3, tag)
    scale = (noise_std / 255.0) * math.sqrt(rows * cols) / 10.0
    re = torch.randn(hr.shape, generator=g, device=hr.device)
    im = torch.randn(hr.shape, generator=g, device=hr.device)
    k = k * mask + torch.complex(re * scale, im * scale)
    mag = torch.fft.ifft2(torch.fft.ifftshift(k, dim=(1, 2))).abs()
    mn = mag.amin(dim=(1, 2), keepdim=True)
    mx = mag.amax(dim=(1, 2), keepdim=True)
    sim = (mag - mn) / (mx - mn).clamp_min(1e-12) * (hi0 - lo0) + lo0
    return F.avg_pool2d(sim.clamp(0.0, 1.0)[:, None], 2)[:, 0]
