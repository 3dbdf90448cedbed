"""Plain PyTorch reference of what the cells time, frozen with the benchmark.

Written from the published descriptions, not from the port: it imports
nothing of ``mri_superresolution_torch`` (nor JAX), and works out again
everything the program derives (per-slice windows, packed codes, the loss,
the Adam update). It computes in float32 with TF32 off (:func:`fp32`).

``precision="fp8"`` is the control: every conv's input and weight rounded
to float8 e4m3 (one scale a tensor, from its largest magnitude), the step
below the bf16 the configurations serve and train in. A comparison that
such a run passes cannot tell a lower precision from the stated one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
ADAM_BETAS = (0.9, 0.999)
INT16_SCALE = 32767.0


@contextlib.contextmanager
def fp32():
    """True float32 convolutions and matmuls for the duration."""
    b = torch.backends
    prev = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = prev


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as the precision holds it: itself in fp32; in fp8, rounded to
    e4m3 under one scale for the tensor, passing the gradient straight
    through."""
    if precision == "fp32":
        return t
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    s = (t.detach().abs().amax() / E4M3_MAX).clamp_min(1e-30)
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach()


def conv(x, w, b=None, padding=0, precision="fp32"):
    return F.conv2d(rounded(x, precision), rounded(w, precision), b,
                    padding=padding)


def gn_leaky(x, scale, bias, groups=8, eps=1e-5, slope=0.2):
    """GroupNorm (population variance) with its affine, then LeakyReLU."""
    return F.leaky_relu(F.group_norm(x, groups, scale, bias, eps), slope)


def upsample2(x):
    """Bilinear 2x with aligned corners (``nn.Upsample(scale_factor=2,
    mode='bilinear', align_corners=True)``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


# ---------------------------------------------------------------- serving


def percentile(s: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row linear-interpolation percentile of row-sorted ``s`` (numpy's
    default method), in float64."""
    n = s.shape[1]
    pos = q / 100.0 * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    frac = pos - lo
    return s[:, lo].double() * (1.0 - frac) + s[:, hi].double() * frac


def normalize(x: torch.Tensor, lower: float = 0.5, upper: float = 99.5):
    """The serving normalize of (n, h, w) slices: clip each slice to its
    [0.5, 99.5] percentile window, then min-max it to [0, 1]; a constant
    slice stays as it is (reference scripts/infer.py:97-130)."""
    x = x.float()
    s = torch.sort(x.reshape(x.shape[0], -1), dim=1).values
    lo = percentile(s, lower).float().view(-1, 1, 1)
    hi = percentile(s, upper).float().view(-1, 1, 1)
    x = torch.minimum(torch.maximum(x, lo), hi)
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    d = mx - mn
    return torch.where(d > 0, (x - mn) / torch.where(d > 0, d, 1.0), x)


def serve_raw_int16(forward, raw: torch.Tensor) -> torch.Tensor:
    """What ``--serve_raw --out_dtype int16`` must answer for stored
    voxels ``raw`` (n, w, h): the slices (n, h, w) normalized, upscaled by
    ``forward`` ((n, h, w, 1) -> (n, 2h, 2w, 1) in [0, 1]), clipped,
    coded as round(y * 32767) and returned in the stored layout
    (n, 2w, 2h), int16."""
    x = normalize(raw.float().transpose(1, 2))
    y = forward(x[..., None])[..., 0].clamp(0.0, 1.0)
    return torch.round(y * INT16_SCALE).to(torch.int16).transpose(1, 2)


def code_gaps(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(largest, mean) |got - want| of int16 codes, in units of the [0, 1]
    range the codes stand for."""
    d = (got.int() - want.int()).abs().double() / INT16_SCALE
    return float(d.max()), float(d.mean())


# ---------------------------------------------------------------- training


def _gauss(window: int, sigma: float, device) -> torch.Tensor:
    c = torch.arange(window, dtype=torch.float64) - window // 2
    g = torch.exp(-(c * c) / (2 * sigma * sigma))
    return (g / g.sum()).float().to(device)


def ssim_per_image(a: torch.Tensor, b: torch.Tensor, window: int = 11,
                   sigma: float = 1.5, val_range: float = 1.0):
    """(n,) SSIM of (n, h, w) images: a zero-padded Gaussian window
    (11, 1.5), C1 = (0.01 L)^2, C2 = (0.03 L)^2, the map's mean (reference
    utils/losses.py)."""
    g = _gauss(window, sigma, a.device)
    w2 = (g[:, None] * g[None, :]).view(1, 1, window, window)
    x = torch.stack([a, b, a * a, b * b, a * b], dim=1).flatten(0, 1)[:, None]
    m = F.conv2d(x, w2, padding=window // 2).view(a.shape[0], 5,
                                                  *a.shape[1:])
    mu1, mu2, e11, e22, e12 = m.unbind(1)
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    c1, c2 = (0.01 * val_range) ** 2, (0.03 * val_range) ** 2
    smap = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return smap.mean(dim=(1, 2))


def l1_ssim_loss(out: torch.Tensor, hr: torch.Tensor, ssim_weight: float):
    """(1 - w) * mean |out - hr| + w * (1 - clip(mean SSIM, 0, 1)) over a
    batch of (n, H, W, 1) images."""
    l1 = (out - hr).abs().mean()
    s = ssim_per_image(out[..., 0], hr[..., 0]).mean().clamp(0.0, 1.0)
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - s)


class Adam:
    """torch-style Adam with L2 weight decay (wd * p added to the gradient
    before the moments), written out. ``state`` (``exp_avg``,
    ``exp_avg_sq``: a tensor a leaf; ``step``: the steps taken) resumes a
    run; by default the moments start at zero."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, betas=ADAM_BETAS, eps=1e-8,
                 state=None):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        if state is None:
            state = {"exp_avg": {k: torch.zeros_like(v)
                                 for k, v in params.items()},
                     "exp_avg_sq": {k: torch.zeros_like(v)
                                    for k, v in params.items()},
                     "step": 0}
        self.m = {k: v.detach().clone().float()
                  for k, v in state["exp_avg"].items()}
        self.v = {k: v.detach().clone().float()
                  for k, v in state["exp_avg_sq"].items()}
        self.t = int(state["step"])
        self.first_grad: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        first = not self.first_grad
        self.t += 1
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k] + self.wd * p
            if first:
                self.first_grad[k] = g.clone()
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))

    def state(self) -> dict:
        return {"exp_avg": {k: v.clone() for k, v in self.m.items()},
                "exp_avg_sq": {k: v.clone() for k, v in self.v.items()},
                "step": self.t}


def train_steps(forward, params: Dict[str, torch.Tensor],
                batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                lr: float, weight_decay: float, ssim_weight: float,
                state=None) -> Tuple[List[float], Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """Steps of L1 + SSIM training from fp32 ``params`` (copied) over
    (lr, hr) batches, from Adam's ``state`` (default: a fresh start):
    (each step's loss, the first step's gradient as Adam takes it, the
    params after the last step)."""
    p = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in params.items()}
    opt = Adam(p, lr, weight_decay, state=state)
    losses = []
    for lo, hi in batches:
        loss = l1_ssim_loss(forward(p, lo), hi, ssim_weight)
        grads = torch.autograd.grad(loss, list(p.values()))
        opt.step(p, dict(zip(p.keys(), grads)))
        losses.append(float(loss.detach()))
    return losses, opt.first_grad, {k: v.detach() for k, v in p.items()}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              moving: List[str]) -> Dict[str, float]:
    """Each leaf of ``moving``: |‖got‖ - ‖want‖| over the larger of ‖want‖
    and the median leaf's ‖want‖."""
    norms = {k: float(want[k].double().norm()) for k in moving}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(got[k].double().norm()) - norms[k]) / max(norms[k],
                                                                    med)
            for k in moving}


def leaf_diffs(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               moving: List[str]) -> Dict[str, float]:
    """Each leaf of ``moving``: ‖got - want‖ over the larger of ‖want‖ and
    the median leaf's ‖want‖. Unlike :func:`leaf_gaps` this sees a
    gradient taken over other rows of the batch, whose norm is alike."""
    norms = {k: float(want[k].double().norm()) for k in moving}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: float((got[k].double() - want[k].double()).norm())
            / max(norms[k], med) for k in moving}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def median(gaps: Dict[str, float]) -> float:
    v = sorted(gaps.values())
    return v[len(v) // 2]


def moving_leaves(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is more than a thousandth of
    the median leaf's (norms): the others move under Adam by round-off
    alone."""
    norms = {k: float(v.double().norm()) for k, v in first_grad.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n > 1e-3 * med]
