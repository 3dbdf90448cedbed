#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, each reported on its own line; any failure exits non-zero before
the last line is printed:

1. build: compile the CUDA kernels from ``mri_superresolution_torch/csrc``.
2. kernels: each kernel (B1 GroupNorm+LeakyReLU, B2 SSIM, B3 narrow 3x3
   conv, B4 leaky+int8 quantize) at the unet's serving shapes (16 slices of
   256^2, base_filters 32, bf16) against its plain PyTorch version, with
   the tolerance stated; kernel, plain and library times L2-cold from CUDA
   graph replays (``utils/timing.cuda_ms_cold``). B1 checks both of its
   routes (the one-pass kernel the wrapper takes at these shapes, and the
   two-pass kernel) within one bf16 ulp and run to run, and times both.
   B4 checks its stream route and the element kernel code for code on
   every finite bf16 code (C = 1 and 16 with each class of scale alone,
   C = 256 with all of them; both slopes) and at its 20 int8 sites, and
   times both there; its fused route (``gn_quantize``, B1's one-pass
   kernel with an int8 output) is checked code for code against B1 + B4,
   run to run, and against its plain version within one code on under
   0.5% of the elements at the seven DoubleConv conv2 sites, and timed
   against B1 (bf16 out) + B4 run separately. B2 runs at one 512^2
   image (``calculate_metrics``) and at batches of 8 (training) and 16
   (serving): within 1e-5 of its plain version, the same bits twice, one
   device kernel a call (``torch.profiler``), then timed twice. With
   ``--parent DIR`` the B2 kernel of the checkout in DIR (an older commit)
   is timed before and after, by ``tools/ssim_time.py`` in a process of
   its own.
3. main path: ``InferenceEngine`` (full-width unet, seeded random weights,
   bf16) upscales 16 synthetic 256^2 slices to 512^2 and reports metrics
   for one of them; the launch counters must show every kernel ran (B1 20
   and B3 2 per forward, B2 1 per metrics call; all 20 B1 launches on the
   one-pass route). Then slices/s, and a 2-slice batch on the CPU port
   held to the bf16 budget (|dPSNR| <= 0.1 dB, |dSSIM| <= 1e-3 against the
   same ground truth).
4. int8 path: ``InferenceEngine(quant="int8", quant_calib_slices=16)``
   calibrates on the 16 slices, freezes (writing its scales sidecar) and
   serves them int8; an int8 forward must launch B4 13 (all on the stream
   route), ``gn_quantize`` 7, B1 13 (one-pass) and B3 0 times. int8 and bf16 slices/s from this call, PSNR/SSIM of
   both against the same ground truth, and the CPU port's int8 forward
   with the same frozen scales on 2 slices held to |dPSNR| <= 0.1 dB.
5. roll probe: the B5 probe's entry point (``tools/roll_probe.run``) at
   (512, 16384): its three kernels exact against their plain versions, and
   their L2-cold device times (replayed from a CUDA graph) beside
   ``x.clone()`` and ``torch.roll``.
6. the ``kernels`` JSON line, the card's name and power limit, and the
   device JSON line last. No kernel's time (and no B5 time, library calls
   included) may fall below its bound: that would mean a broken yardstick.
   The B3 times are bf16, the tensor-core kernel. B1's row gives the
   one-pass route's time, and the two-pass route's as ``earlier_ms``;
   B4's row its stream route over the 13 sites it serves on the int8 path,
   the element kernel's there as ``earlier_ms``, and both over all 20
   sites as ``all_20_sites``; the ``gn_quantize`` row the fused route over
   the seven conv2 sites, and B1 + B4 there as ``earlier_ms``; B2's row
   the batch of 8 (the batch of 16 beside it as ``batch16``), and the one
   image on a row of its own (with ``--parent``, the older kernel's time
   as ``earlier_ms``).

Needs one CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# the port itself, from the checkout this script sits in: without it the
# script fails here, before it prints anything
from mri_superresolution_torch import kernels
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer import InferenceEngine
from mri_superresolution_torch.kernels import _build
from mri_superresolution_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
from mri_superresolution_torch.kernels.groupnorm import (
    gn_quantize, gn_quantize_plain, group_norm_leaky, group_norm_leaky_plain,
    group_norm_leaky_twopass, onepass_plan)
from mri_superresolution_torch.kernels.leaky_quantize import (
    leaky_quantize, leaky_quantize_generic, leaky_quantize_plain)
from mri_superresolution_torch.kernels.ssim import (
    flops_per_pixel as ssim_flops_per_pixel, ssim_per_sample,
    ssim_per_sample_plain)
from mri_superresolution_torch.models import build_model, param_count
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.ops.metrics import psnr
from mri_superresolution_torch.ops.ssim import ssim
from mri_superresolution_torch.tools import roll_probe
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.timing import (cuda_ms, cuda_ms_cold,
                                                    l2_cold_copies)

# H100 SXM published peaks (dense): memory 3.35 TB/s, bf16 tensor cores
# 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
# int8 codes against a plain version that rounds differently before the
# quantize: the JAX package's int8 probe bound (tools/bench_int8_probe4.py)
CODES_MAX_DIFF, CODES_MAX_FRAC = 1, 0.005
BATCH, LR, BASE_FILTERS = 16, 256, 32
PROBE_ROWS, PROBE_LANES = 512, 16384
# B2: one 512^2 image (calculate_metrics), the training batch (the JAX
# package's default TrainConfig.batch_size) and the serving batch
B2_SHAPES = ((1, 512, 512), (8, 512, 512), (16, 512, 512))
B2_ROW_SHAPE = (8, 512, 512)
SSIM_TIME = Path(__file__).resolve().parent / "mri_superresolution_torch" / \
    "tools" / "ssim_time.py"
# written by the int8 engine when its scales freeze; build/ is not
# committed
SCALES_PATH = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
    "int8_scales.json"


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def within(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float) -> tuple:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    return ok, float(err.max())


def gn_sites(b: int, lr: int, f: int):
    """(B, C, H, W) of the unet's 20 GroupNorm+LeakyReLU sites, with counts."""
    return [((b, f, lr, lr), 2 + 3),                       # inc, up3
            ((b, 2 * f, lr // 2, lr // 2), 2 + 3),         # down1, up2
            ((b, 4 * f, lr // 4, lr // 4), 2 + 3),         # down2, up1
            ((b, 8 * f, lr // 8, lr // 8), 2),            # down3
            ((b, f // 2, 2 * lr, 2 * lr), 3)]             # final stage


def check_b1(dev, gen) -> dict:
    """B1 at the unet's five GroupNorm shapes: both routes (the one-pass
    kernel the wrapper takes there, and the two-pass kernel) against the
    plain version and run to run, then every time L2-cold from CUDA graph
    replays, the library's GroupNorm + LeakyReLU timed the same way."""
    keys = ("ms", "earlier_ms", "plain_ms", "library_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    worst, bound_by = 0.0, "bytes"
    for shape, count in gn_sites(BATCH, LR, BASE_FILTERS):
        x = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        c = shape[1]
        g = torch.randn(c, generator=gen, device=dev)
        b = torch.randn(c, generator=gen, device=dev)
        plan = onepass_plan(x, torch.empty_like(x))
        if plan is None:
            raise AssertionError(f"B1's one-pass route does not take {shape}")
        want = group_norm_leaky_plain(x, g, b)
        for route, fn in (("onepass", group_norm_leaky),
                          ("twopass", group_norm_leaky_twopass)):
            got = fn(x, g, b)
            ok, err = within(got, want, BF16_RTOL, 1e-5)
            same = torch.equal(got, fn(x, g, b))
            log("kernel_check", kernel="B1", route=route, shape=list(shape),
                dtype="bf16", plan=plan._asdict(), max_abs_err=err,
                rtol=BF16_RTOL, atol=1e-5, run_to_run_equal=same, ok=ok)
            if not (ok and same):
                raise AssertionError(f"B1 ({route}) disagrees with its plain "
                                     f"version at {shape} (max abs err "
                                     f"{err}) or from run to run ({same})")
            if route == "onepass":
                worst = max(worst, err)
        gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: group_norm_leaky(t, g, b), xs)
        two = cuda_ms_cold(lambda t: group_norm_leaky_twopass(t, g, b), xs)
        p = cuda_ms_cold(lambda t: group_norm_leaky_plain(t, g, b), xs)
        lib = cuda_ms_cold(
            lambda t: F.leaky_relu(F.group_norm(t, 8, gb, bb), 0.2), xs)
        del xs
        bnd, bound_by = bound_ms(2 * x.numel() * x.element_size(),
                                 10 * x.numel(), torch.bfloat16)
        log("kernel_time", kernel="B1", shape=list(shape), sites=count,
            kernel_ms=k, twopass_ms=two, plain_ms=p, library_ms=lib,
            bound_ms=bnd, bound_share=bnd / k, twopass_bound_share=bnd / two,
            timing="L2-cold, CUDA graph replays")
        below = {name: v for name, v in (("onepass", k), ("twopass", two),
                                         ("plain", p), ("library", lib))
                 if v < bnd}
        if below:
            raise AssertionError(f"B1 times below their {bnd} ms bound at "
                                 f"{shape}: {below}")
        for key, v in zip(keys, (k, two, p, lib, bnd)):
            tot[key] += count * v
    log("kernel_total", kernel="B1", sites=20, **tot,
        bound_share=tot["bound_ms"] / tot["ms"])
    return {**tot, "max_abs_err": worst, "bound_by": bound_by}


def check_b3(dev, gen) -> dict:
    f, hr = BASE_FILTERS, 2 * LR
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    worst, bound_by = 0.0, "bytes"
    for ci, co in ((f, f // 2), (f // 2, f // 2)):   # final_up_conv, conv1
        x = torch.randn((BATCH, ci, hr, hr), generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = (torch.randn((co, ci, 3, 3), generator=gen, device=dev)
             / math.sqrt(9 * ci)).to(torch.bfloat16)
        ok, err = within(conv3x3(x, w), conv3x3_plain(x, w), BF16_RTOL, 1e-4)
        log("kernel_check", kernel="B3", shape=list(x.shape), cout=co,
            dtype="bf16", max_abs_err=err, rtol=BF16_RTOL, atol=1e-4, ok=ok)
        if not ok:
            raise AssertionError(f"B3 disagrees with its plain version at "
                                 f"{ci}->{co}: max abs err {err}")
        worst = max(worst, err)
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: conv3x3(t, w), xs)
        p = cuda_ms_cold(lambda t: conv3x3_plain(t, w), xs)
        lib = cuda_ms_cold(lambda t: F.conv2d(t, w, padding=1), xs)
        del xs
        out_numel = BATCH * co * hr * hr
        bnd, bound_by = bound_ms(
            (x.numel() + w.numel() + out_numel) * 2,
            2.0 * out_numel * 9 * ci, torch.bfloat16)
        log("kernel_time", kernel="B3", shape=list(x.shape), cout=co,
            kernel_ms=k, plain_ms=p, library_ms=lib, bound_ms=bnd,
            bound_share=bnd / k, library_over_kernel=lib / k,
            timing="L2-cold, CUDA graph replays")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("bound_ms", bnd)):
            tot[key] += v
    return {**tot, "max_abs_err": worst, "bound_by": bound_by}


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs, from
    ``torch.profiler``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def b2_bound(shape) -> tuple:
    # one read of both images, one fp32 write an image; the least fp32
    # work of the function (kernels/ssim.flops_per_pixel, an FMA counts 2)
    b, h, w = shape
    return bound_ms(2 * b * h * w * 4 + 4 * b,
                    float(ssim_flops_per_pixel(11)) * b * h * w,
                    torch.float32)


def parent_b2_ms(parent: str) -> dict:
    """B2's L2-cold times, by shape, of the port in the checkout ``parent``
    (an older commit), from ``tools/ssim_time.py`` in a process of its
    own, which builds that checkout's kernels."""
    shapes = ["x".join(map(str, s)) for s in B2_SHAPES]
    r = subprocess.run([sys.executable, str(SSIM_TIME), "--tree", parent,
                        "--shapes", *shapes], capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"timing B2 in {parent} failed:\n"
                             f"{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    return {tuple(int(v) for v in k.split("x")): v
            for k, v in res["ms"].items()}


def check_b2(dev, gen, parent=None) -> dict:
    """B2 at one image (``calculate_metrics``) and at the training and
    serving batches: within 1e-5 of the plain version, the same bits twice,
    one device kernel a call (``torch.profiler``); then L2-cold times from
    CUDA graph replays, twice, and the plain version's. With ``parent``
    (a checkout of an older commit) that commit's kernel is timed before
    and after, in processes of their own: its times are ``earlier_ms``."""
    earlier = [parent_b2_ms(parent)] if parent else []
    rows = {}
    for shape in B2_SHAPES:
        a = torch.rand(shape, generator=gen, device=dev)
        b = (a + 0.05 * torch.randn(shape, generator=gen,
                                    device=dev)).clamp(0, 1)
        got, want = ssim_per_sample(a, b), ssim_per_sample_plain(a, b)
        ok, err = within(got, want, 0.0, 1e-5)
        same = torch.equal(got, ssim_per_sample(a, b))
        names = device_kernels(lambda: ssim_per_sample(a, b))
        log("kernel_check", kernel="B2", shape=list(shape), dtype="fp32",
            max_abs_err=err, atol=1e-5, run_to_run_equal=same,
            device_kernels=names, ssim_first=float(got[0]), ok=ok)
        if not (ok and same and len(names) == 1):
            raise AssertionError(f"B2 at {shape}: max abs err {err} (gate "
                                 f"1e-5), run to run equal {same}, device "
                                 f"kernels a call {names}")
        pairs = l2_cold_copies(torch.stack([a, b]))
        runs = [cuda_ms_cold(lambda t: ssim_per_sample(t[0], t[1]), pairs)
                for _ in range(2)]
        p = cuda_ms_cold(lambda t: ssim_per_sample_plain(t[0], t[1]), pairs)
        del pairs
        k = sum(runs) / 2
        bnd, bound_by = b2_bound(shape)
        rows[shape] = {"ms": k, "plain_ms": p, "library_ms": None,
                       "bound_ms": bnd, "bound_by": bound_by,
                       "max_abs_err": err, "shape": list(shape),
                       "ms_runs": runs}
        if min(runs + [p]) < bnd:
            raise AssertionError(f"B2 times below their {bnd} ms bound at "
                                 f"{shape}: {runs}, {p}")
    if parent:
        earlier.append(parent_b2_ms(parent))
    for shape, r in rows.items():
        if earlier:
            r["earlier_runs"] = [e[shape] for e in earlier]
            r["earlier_ms"] = sum(r["earlier_runs"]) / len(earlier)
        log("kernel_time", kernel="B2", shape=r["shape"], kernel_ms=r["ms"],
            kernel_runs=r["ms_runs"], earlier_ms=r.get("earlier_ms"),
            earlier_runs=r.get("earlier_runs"), plain_ms=r["plain_ms"],
            library_ms=None, bound_ms=r["bound_ms"],
            bound_share=r["bound_ms"] / r["ms"],
            timing="L2-cold, CUDA graph replays; earlier: parent, this, "
                   "this, parent" if earlier else "L2-cold, CUDA graph "
                   "replays")
    # the row: the training batch; the serving batch beside it, one image
    # on its own row
    row = dict(rows[B2_ROW_SHAPE])
    row["batch16"] = rows[(16, 512, 512)]
    return {**row, "one_image": rows[(1, 512, 512)]}


def b4_sites(b: int, lr: int, f: int):
    """(site, (B, C, H, W), slope) of the int8 unet's 20 quantize sites:
    slope 0.2 where B4 applies the LeakyReLU a DoubleConv's first
    GroupNorm left owing, 1.0 elsewhere."""
    sites = []

    def dc(name, cin, cout, hw):
        sites.append((f"{name}.conv1", (b, cin, hw, hw), 1.0))
        sites.append((f"{name}.conv2", (b, cout, hw, hw), 0.2))

    dc("inc", 1, f, lr)
    for i in (1, 2, 3):
        dc(f"down{i}", f << (i - 1), f << i, lr >> i)
    for i in (1, 2, 3):
        cin, hw = f << (4 - i), lr >> (3 - i)
        sites.append((f"up{i}.up_conv", (b, cin, hw // 2, hw // 2), 1.0))
        dc(f"up{i}.conv", cin, cin // 2, hw)      # skip + cin/2 in
    sites.append(("final_up_conv", (b, f, 2 * lr, 2 * lr), 1.0))
    sites.append(("final_up_pixelshuffle.conv", (b, f, lr, lr), 1.0))
    sites.append(("final_conv1", (b, f // 2, 2 * lr, 2 * lr), 1.0))
    return sites


# classes of per-channel scales of the exhaustive check: 1.0, amax /
# 127-like values, non-powers of two near both ends of [2^-64, 2^64] (the
# stream kernel's reciprocal route), and extremes outside it (its IEEE
# division)
EXHAUSTIVE_SCALES = (1.0, 0.0123, 3.7 / 127, 1e-30, 1e30, 1.0 / 3.0, 7.1e-20,
                     5.5e18)
# the stream kernel's elements a thread: the channels that share a route
STREAM_GROUP = 16


def every_bf16(c: int, dev, cls: int = 0) -> tuple:
    """(1, c, 256, 256) bf16 channels-last holding every finite bf16 code
    in every channel (rotated by the channel's index; 256 spare zeros),
    and (c,) scales that differ from channel to channel. Each group of 16
    channels (one stream thread's) takes one class of scale, class ``cls``
    for the first group and the next classes after it, so that a thread
    whose scales all lie in [2^-64, 2^64] runs the reciprocal route."""
    bits = (torch.arange(65536, dtype=torch.int32) << 16).view(torch.float32)
    col = torch.cat([bits[torch.isfinite(bits)], torch.zeros(256)])
    x = torch.stack([col.roll(17 * k) for k in range(c)], dim=1).to(
        torch.bfloat16).to(dev).view(1, 256, 256, c).permute(0, 3, 1, 2)
    n = len(EXHAUSTIVE_SCALES)
    s = torch.tensor([EXHAUSTIVE_SCALES[(k // STREAM_GROUP + cls) % n]
                      * (1 + k / 997) for k in range(c)], device=dev)
    return x, s


def reciprocal_groups(s: torch.Tensor) -> tuple:
    """(groups of 16 channels whose scales all lie in [2^-64, 2^64], all
    groups): the stream threads that take the reciprocal route, not the
    IEEE division (``csrc/quantize.cuh``, ``quant_fast_ok``)."""
    a = s.abs().cpu()
    ok = (a >= 2.0 ** -64) & (a <= 2.0 ** 64)
    groups = ok.view(-1, STREAM_GROUP) if s.numel() >= STREAM_GROUP \
        else ok.view(1, -1)
    return int(groups.all(dim=1).sum()), groups.shape[0]


def b4_bound(x: torch.Tensor) -> tuple:
    # one read of x (bf16) and the scales, one write of the codes; ~6 fp32
    # operations an element (compare, mul, div, round, 2 clamps)
    return bound_ms(3 * x.numel() + 4 * x.shape[1], 6.0 * x.numel(),
                    torch.float32)


def check_b4(dev, gen) -> dict:
    """B4's stream route and the element kernel it replaces: code for code
    against the plain version on every finite bf16 code (C = 1 and 16 with
    each class of scale alone, so that every in-range class runs the
    stream kernel's reciprocal route on every code; C = 256 with all
    classes at once) and at the 20 unet sites, then both L2-cold at every
    site. The row reports the 13 sites the stream route serves on the int8
    path (the element kernel's sum there is its earlier_ms), and the sums
    over all 20 beside them."""
    n = len(EXHAUSTIVE_SCALES)
    cases = [(c, cls) for c in (1, 16) for cls in range(n)] + [(256, 0)]
    for c, cls in cases:
        x, s = every_bf16(c, dev, cls)
        fast, groups = reciprocal_groups(s)
        for slope in (0.2, 1.0):
            want = leaky_quantize_plain(x, s, slope)
            before = leaky_quantize.stream_launches
            got = leaky_quantize(x, s, slope)
            stream = leaky_quantize.stream_launches == before + 1
            same = torch.equal(got, leaky_quantize(x, s, slope))
            ok = torch.equal(got, want) and stream and torch.equal(
                leaky_quantize_generic(x, s, slope), want)
            log("kernel_check", kernel="B4", check="every finite bf16 code",
                shape=list(x.shape), slope=slope, scale_class=cls,
                first_scale=float(s[0]), reciprocal_groups=fast,
                groups=groups, routes=["stream", "element"], exact=ok,
                run_to_run_equal=same)
            if not (ok and same):
                raise AssertionError(f"B4 disagrees with its plain version on "
                                     f"the bf16 codes at C = {c}, scale class "
                                     f"{cls}, slope {slope} (stream route "
                                     f"taken: {stream})")
        del x, want, got
    keys = ("ms", "earlier_ms", "plain_ms", "bound_ms")
    tot, fused, standalone = (dict.fromkeys(keys, 0.0) for _ in range(3))
    bound_by, elems = "bytes", 0
    for site, shape, slope in b4_sites(BATCH, LR, BASE_FILTERS):
        x = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        # calibration-like scales (amax / 127), a little short so that
        # some codes saturate
        scale = (x.float().abs().amax(dim=(0, 2, 3)) / 140.0).contiguous()
        want = leaky_quantize_plain(x, scale, slope)
        before = leaky_quantize.stream_launches
        got = leaky_quantize(x, scale, slope)
        ok = torch.equal(got, want) and \
            leaky_quantize.stream_launches == before + 1 and \
            torch.equal(leaky_quantize_generic(x, scale, slope), want)
        log("kernel_check", kernel="B4", site=site, shape=list(shape),
            slope=slope, dtype="bf16->s8", routes=["stream", "element"],
            exact=ok, saturated=int((got.abs() == 127).sum()))
        if not ok:
            raise AssertionError(f"B4 disagrees with its plain version at "
                                 f"{site} {shape}")
        del got, want
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: leaky_quantize(t, scale, slope), xs)
        e = cuda_ms_cold(lambda t: leaky_quantize_generic(t, scale, slope),
                         xs)
        p = cuda_ms_cold(lambda t: leaky_quantize_plain(t, scale, slope), xs)
        del xs
        bnd, bound_by = b4_bound(x)
        log("kernel_time", kernel="B4", site=site, shape=list(shape),
            kernel_ms=k, element_ms=e, plain_ms=p, library_ms=None,
            bound_ms=bnd, bound_share=bnd / k, element_bound_share=bnd / e,
            timing="L2-cold, CUDA graph replays")
        if min(k, e, p) < bnd:
            raise AssertionError(f"B4 times below their {bnd} ms bound at "
                                 f"{site}: {k}, {e}, {p}")
        part = fused if slope != 1.0 else standalone
        for key, v in zip(keys, (k, e, p, bnd)):
            tot[key] += v
            part[key] += v
        elems += x.numel()
        del x
    log("kernel_total", kernel="B4", sites=20, elements=elems, **tot,
        bound_share=tot["bound_ms"] / tot["ms"],
        standalone_13=standalone, conv2_7=fused,
        note="ms: stream route; earlier_ms: element kernel")
    # the row: the 13 sites B4 serves on the int8 path (the seven conv2
    # sites run in gn_quantize's row)
    return {**standalone, "library_ms": None, "max_abs_err": 0.0,
            "bound_by": bound_by, "sites": 13, "all_20_sites": tot}


def check_fused(dev, gen) -> dict:
    """B4's fused route (gn_quantize: B1's one-pass kernel with an int8
    output) at the seven DoubleConv conv2 sites: code for code against B1
    at slope 1.0 followed by the plain B4, run to run, and against its own
    plain version (``gn_quantize_plain``) within one code on under 0.5% of
    the elements; then L2-cold against B1 (bf16 out) + B4 run separately
    (earlier_ms)."""
    keys = ("ms", "earlier_ms", "b1_bf16_ms", "plain_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    bound_by = "bytes"
    for site, shape, slope in b4_sites(BATCH, LR, BASE_FILTERS):
        if slope == 1.0:
            continue
        x = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        c = shape[1]
        g = torch.randn(c, generator=gen, device=dev)
        b = torch.randn(c, generator=gen, device=dev)
        y = group_norm_leaky(x, g, b, negative_slope=1.0)
        s = (y.float().abs().amax(dim=(0, 2, 3)) / 140.0).contiguous()
        want = leaky_quantize_plain(y, s, slope)
        before = gn_quantize.launches
        got = gn_quantize(x, g, b, s, slope)
        ok = torch.equal(got, want) and gn_quantize.launches == before + 1
        same = torch.equal(got, gn_quantize(x, g, b, s, slope))
        # against its own plain version (the GroupNorm in fp32 in PyTorch),
        # whose bf16 output may differ from B1's by one ulp
        d = (got.short() - gn_quantize_plain(x, g, b, s, slope).short()).abs()
        d_max, d_frac = int(d.max()), float((d != 0).float().mean())
        close = d_max <= CODES_MAX_DIFF and d_frac < CODES_MAX_FRAC
        log("kernel_check", kernel="B4 fused", site=site, shape=list(shape),
            slope=slope, dtype="bf16->s8", exact_vs_b1_plus_b4=ok,
            run_to_run_equal=same, vs_plain_max_code_diff=d_max,
            vs_plain_frac_differing=d_frac, vs_plain_close=close,
            bound=f"codes within {CODES_MAX_DIFF} on under "
                  f"{CODES_MAX_FRAC:.1%} of elements",
            saturated=int((got.abs() == 127).sum()))
        if not (ok and same and close):
            raise AssertionError(f"gn_quantize disagrees with B1 + B4 at "
                                 f"{site} {shape} ({ok}), from run to run "
                                 f"({same}) or with its plain version (codes "
                                 f"up to {d_max} apart on {d_frac:.3%})")
        del y, got, want, d
        xs = l2_cold_copies(x)
        k = cuda_ms_cold(lambda t: gn_quantize(t, g, b, s, slope), xs)
        two = cuda_ms_cold(lambda t: leaky_quantize(
            group_norm_leaky(t, g, b, negative_slope=1.0), s, slope), xs)
        b1 = cuda_ms_cold(
            lambda t: group_norm_leaky(t, g, b, negative_slope=1.0), xs)
        p = cuda_ms_cold(lambda t: gn_quantize_plain(t, g, b, s, slope), xs)
        del xs
        # one read of x (bf16), one write of the codes, the (C,) gamma,
        # beta and scales; ~16 fp32 operations an element (statistics,
        # affine, LeakyReLU, quantize)
        bnd, bound_by = bound_ms(3 * x.numel() + 12 * c, 16.0 * x.numel(),
                                 torch.float32)
        log("kernel_time", kernel="B4 fused", site=site, shape=list(shape),
            kernel_ms=k, b1_plus_b4_ms=two, b1_bf16_ms=b1, plain_ms=p,
            library_ms=None, bound_ms=bnd, bound_share=bnd / k,
            timing="L2-cold, CUDA graph replays")
        if min(k, two, b1, p) < bnd:
            raise AssertionError(f"fused B4 times below their {bnd} ms bound "
                                 f"at {site}: {k}, {two}, {b1}, {p}")
        for key, v in zip(keys, (k, two, b1, p, bnd)):
            tot[key] += v
        del x
    log("kernel_total", kernel="B4 fused", sites=7, **tot,
        bound_share=tot["bound_ms"] / tot["ms"],
        note="earlier_ms: B1 bf16 out + B4 stream, run separately")
    return {**tot, "library_ms": None, "max_abs_err": 0.0,
            "bound_by": bound_by}


def main_path(dev, cfg, params, lr, hr):
    # the serving path's peak, not the kernel phases' timing buffers
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(cfg, params, bf16=True, device=dev)
    engine.upscale_batch(lr[:2])                    # load the library, warm

    kernels.reset_launch_counts()
    out = engine.upscale_batch(lr)
    metrics = engine.calculate_metrics(out[0], hr[0], dev)
    counts = kernels.launch_counts()
    onepass = group_norm_leaky.onepass_launches
    log("main_path", slices=BATCH, input=[LR, LR], output=list(out.shape[1:]),
        params=param_count(engine.model), launches=counts,
        onepass_launches=onepass, metrics=metrics)
    if out.shape != (BATCH, 2 * LR, 2 * LR) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"bad output: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    want = dict.fromkeys(counts, 0)
    want.update(group_norm_leaky=20, conv3x3=2, ssim_per_sample=1)
    if counts != want or onepass != 20:
        raise AssertionError(f"launch counts {counts} (B1 one-pass "
                             f"{onepass}), expected {want} (20)")

    # end-to-end serving rate: host batch in, host batch out
    iters = 10
    ms = cuda_ms(lambda: engine.upscale_batch(lr), iters=iters, warmup=2)
    fwd_ms = cuda_ms(lambda: engine._dispatch_once(lr), iters=iters,
                     warmup=2)
    log("throughput", batch=BATCH, ms_per_batch=ms,
        slices_per_s=BATCH / ms * 1e3, forward_ms_per_batch=fwd_ms,
        forward_slices_per_s=BATCH / fwd_ms * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the CPU port on 2 of the slices, held to the bf16 budget
    cpu = InferenceEngine(cfg, params, bf16=True, device="cpu")
    out_cpu = cpu.upscale_batch(lr[:2])
    gt = torch.from_numpy(hr[:2, :, :, None])
    g, c = torch.from_numpy(out[:2, :, :, None]), torch.from_numpy(
        out_cpu[:, :, :, None])
    d_psnr = abs(float(psnr(g, gt)) - float(psnr(c, gt)))
    d_ssim = abs(float(ssim(g, gt)) - float(ssim(c, gt)))
    ok = d_psnr <= 0.1 and d_ssim <= 1e-3
    log("cpu_vs_gpu", slices=2, d_psnr_db=d_psnr, d_ssim=d_ssim,
        psnr_gpu_vs_cpu=float(psnr(g, c)),
        max_abs_diff=float(np.abs(out[:2] - out_cpu).max()), ok=ok)
    if not ok:
        raise AssertionError("GPU and CPU ports differ beyond the bf16 "
                             "budget")
    return counts, engine


def _quality(out: np.ndarray, gt: np.ndarray) -> dict:
    o = torch.from_numpy(np.ascontiguousarray(out)[..., None])
    g = torch.from_numpy(np.ascontiguousarray(gt)[..., None])
    return {"psnr_db": float(psnr(o, g)), "ssim": float(ssim(o, g))}


def int8_path(dev, cfg, params, lr, hr, bf16_engine) -> dict:
    SCALES_PATH.parent.mkdir(parents=True, exist_ok=True)
    SCALES_PATH.unlink(missing_ok=True)
    engine = InferenceEngine(cfg, params, bf16=True, device=dev,
                             quant="int8", quant_calib_slices=BATCH,
                             quant_calib_path=str(SCALES_PATH))
    first = engine.upscale_batch(lr)     # calibrates, freezes, serves int8
    log("int8_calibrate", batches=dict(engine._quant_batches),
        calib_slices=engine._calib_seen, frozen=not engine.quant_calibrating,
        sidecar=SCALES_PATH.exists(), summary=engine.quant_summary())
    if engine._quant_batches != {"int8": 1, "bf16": 0} or \
            engine.quant_calibrating or not SCALES_PATH.exists():
        raise AssertionError("the int8 engine did not calibrate, freeze and "
                             "re-serve the batch int8")
    names = [s for s, _ in quant_forward.quant_sites(engine._params)]
    if names != [s for s, _, _ in b4_sites(BATCH, LR, BASE_FILTERS)]:
        raise AssertionError("b4_sites does not list the int8 sites")

    kernels.reset_launch_counts()
    out = engine.upscale_batch(lr)
    counts = kernels.launch_counts()
    onepass = group_norm_leaky.onepass_launches
    stream = leaky_quantize.stream_launches
    want = dict.fromkeys(counts, 0)
    want.update(group_norm_leaky=13, leaky_quantize=13, gn_quantize=7)
    bf16_out = bf16_engine.upscale_batch(lr)
    q_int8, q_bf16 = _quality(out, hr), _quality(bf16_out, hr)
    log("int8_path", slices=BATCH, launches=counts, onepass_launches=onepass,
        stream_launches=stream,
        output=list(out.shape[1:]), int8_vs_gt=q_int8, bf16_vs_gt=q_bf16,
        mean_abs_int8_vs_bf16=float(np.abs(out - bf16_out).mean()),
        same_as_first=bool(np.array_equal(out, first)))
    if counts != want or onepass != 13 or stream != 13:
        raise AssertionError(f"int8 launch counts {counts} (B1 one-pass "
                             f"{onepass}, B4 stream {stream}), expected "
                             f"{want} (13, 13)")
    if out.shape != (BATCH, 2 * LR, 2 * LR) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"bad int8 output: shape {out.shape}")

    # serving rates of both engines in this call, in turns
    iters = 10
    t = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        eng = bf16_engine if name == "bf16" else engine
        t[name].append(cuda_ms(lambda: eng.upscale_batch(lr), iters=iters,
                               warmup=2))
    fwd = {name: cuda_ms(lambda: eng._dispatch_once(lr), iters=iters,
                         warmup=2)
           for name, eng in (("bf16", bf16_engine), ("int8", engine))}
    rates = {name: BATCH / (sum(v) / len(v)) * 1e3 for name, v in t.items()}
    log("int8_throughput", batch=BATCH, ms_per_batch=t,
        slices_per_s=rates, forward_ms_per_batch=fwd,
        forward_slices_per_s={k: BATCH / v * 1e3 for k, v in fwd.items()},
        int8_over_bf16=rates["int8"] / rates["bf16"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the CPU port's int8 forward with the card's frozen scales
    cpu = InferenceEngine(cfg, params, bf16=True, device="cpu",
                          quant="int8", quant_calib_path=str(SCALES_PATH))
    out_cpu = cpu.upscale_batch(lr[:2])
    g, c = _quality(out[:2], hr[:2]), _quality(out_cpu, hr[:2])
    d_psnr = abs(g["psnr_db"] - c["psnr_db"])
    ok = d_psnr <= 0.1 and cpu._quant_batches == {"int8": 1, "bf16": 0}
    log("int8_cpu_vs_gpu", slices=2, d_psnr_db=d_psnr,
        d_ssim=abs(g["ssim"] - c["ssim"]),
        mean_abs_diff=float(np.abs(out[:2] - out_cpu).mean()),
        max_abs_diff=float(np.abs(out[:2] - out_cpu).max()), ok=ok)
    if not ok:
        raise AssertionError("GPU and CPU int8 ports differ beyond the bf16 "
                             "budget")
    return counts


def probe_bound_ms() -> float:
    return bound_ms(2 * PROBE_ROWS * PROBE_LANES * 2, 0.0, torch.bfloat16)[0]


def probe_path(dev) -> tuple:
    kernels.reset_launch_counts()
    res = roll_probe.run(PROBE_ROWS, PROBE_LANES, dev)
    counts = kernels.launch_counts()
    log("roll_probe", rows=PROBE_ROWS, lanes=PROBE_LANES, results=res,
        launches={k: counts[k] for k in ("roll_copy", "roll32", "taps3")})
    if not all(counts[k] > 0 for k in ("roll_copy", "roll32", "taps3")):
        raise AssertionError(f"the probe launched no kernel: {counts}")
    bound_us = probe_bound_ms() * 1e3
    below = {f"{name}.{key}": r[key] for name, r in res.items()
             for key in ("us", "plain_us", "library_us")
             if r[key] is not None and r[key] < bound_us}
    if below:
        raise AssertionError(f"B5 times below their {bound_us} us bound: "
                             f"{below}")
    return res, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one "
                                 "NVIDIA GPU")
    ap.add_argument("--parent", default=None,
                    help="checkout of an older commit whose B2 kernel is "
                         "timed beside this one (earlier_ms)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    # fp32 comparisons on the card in full fp32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = _build.build()
    lines = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    regs = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    # kernels whose registers spill: ptxas names the function, then reports
    spills, func = [], None
    for ln in lines:
        if "Function properties for" in ln:
            func = ln.split("Function properties for")[-1].strip()
        elif re.search(r"[1-9]\d* bytes spill stores", ln):
            spills.append(f"{func}: {ln.strip()}")
    log("build", seconds=time.perf_counter() - t0, library=str(lib),
        ptxas=regs[:24], spills=spills)

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"B1": check_b1(dev, gen), "B3": check_b3(dev, gen),
               "B2": check_b2(dev, gen, args.parent),
               "B4": check_b4(dev, gen),
               "B4 fused": check_fused(dev, gen)}
    cfg = ModelConfig(base_filters=BASE_FILTERS)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    lr = phantom_batch(np.random.default_rng(0), BATCH, LR)
    hr = phantom_batch(np.random.default_rng(0), BATCH, 2 * LR)
    counts, bf16_engine = main_path(dev, cfg, params, lr, hr)
    counts_int8 = int8_path(dev, cfg, params, lr, hr, bf16_engine)
    probe, counts_probe = probe_path(dev)

    torch_root = "mri_superresolution_torch/csrc/"
    tpu_root = "mri_superresolution_tpu/experiments/"
    meta = {
        "B1": ("group_norm_leaky", torch_root + "groupnorm_onepass.cu",
               tpu_root + "groupnorm_pallas.py:167", counts),
        "B2": ("ssim_per_sample", torch_root + "ssim_fused.cu",
               tpu_root + "ssim_pallas.py:75", counts),
        "B3": ("conv3x3", torch_root + "conv3x3_mma.cu",
               tpu_root + "conv_pallas.py:107", counts),
        "B4": ("leaky_quantize", torch_root + "leaky_quantize.cu",
               "tools/bench_int8_probe4.py:57", counts_int8),
        "B4 fused": ("gn_quantize", torch_root + "groupnorm_onepass.cu",
                     "tools/bench_int8_probe4.py:57", counts_int8),
    }
    rows = []
    for key in ("B1", "B2", "B3", "B4", "B4 fused"):
        name, source, replaces, launches = meta[key]
        r = results[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
        for extra in ("earlier_ms", "sites", "all_20_sites", "shape",
                      "batch16"):
            if extra in r:
                rows[-1][extra] = r[extra]
        if key == "B2":
            one = r["one_image"]
            rows.append({**rows[-1], **{k: one[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "shape")}})
            rows[-1].pop("batch16")
            rows[-1].pop("earlier_ms", None)
            if "earlier_ms" in one:
                rows[-1]["earlier_ms"] = one["earlier_ms"]
    for name, wrapper in (("copy", "roll_copy"), ("roll32", "roll32"),
                          ("taps3", "taps3")):
        r = probe[name]
        rows.append({"name": wrapper, "route": "cuda",
                     "source": torch_root + "roll_probe.cu",
                     "replaces": "tools/bench_roll_probe.py:98",
                     "launches": counts_probe[wrapper], "max_abs_err": 0.0,
                     "ms": r["us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
                     "bound_ms": probe_bound_ms(), "bound_by": "bytes",
                     "library_ms": None if r["library_us"] is None
                     else r["library_us"] / 1e3})
    below = [r["name"] for r in rows if r["ms"] < r["bound_ms"]]
    if below:
        raise AssertionError(f"kernel times below their bound: {below}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
