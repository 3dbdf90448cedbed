#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero before
the last line is printed:

1. build: compile the CUDA kernels from ``mri_superresolution_torch/csrc``.
2. kernels: each kernel (B1 GroupNorm+LeakyReLU, B2 SSIM, B3 narrow 3x3
   conv) at the unet's serving shapes (16 slices of 256^2, base_filters 32,
   bf16) against its plain PyTorch version, with the tolerance stated;
   kernel, plain and library times by CUDA events.
3. main path: ``InferenceEngine`` (full-width unet, seeded random weights,
   bf16) upscales 16 synthetic 256^2 slices to 512^2 and reports metrics
   for one of them; the launch counters must show every kernel ran (B1 20
   and B3 2 per forward, B2 1 per metrics call). Then slices/s, and a
   2-slice batch on the CPU port held to the bf16 budget (|dPSNR| <= 0.1 dB,
   |dSSIM| <= 1e-3 against the same ground truth).
4. the ``kernels`` JSON line, the card's name and power limit, and the
   device JSON line last.

Needs one CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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
    group_norm_leaky, group_norm_leaky_plain)
from mri_superresolution_torch.kernels.ssim import (ssim_per_sample,
                                                    ssim_per_sample_plain)
from mri_superresolution_torch.models import build_model, param_count
from mri_superresolution_torch.ops.metrics import psnr
from mri_superresolution_torch.ops.ssim import ssim

# H100 SXM published peaks (dense): memory 3.35 TB/s, bf16 tensor cores
# 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
BATCH, LR, BASE_FILTERS = 16, 256, 32


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    worst, bound_by = 0.0, "bytes"
    for shape, count in gn_sites(BATCH, LR, BASE_FILTERS):
        x = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        c = shape[1]
        g = torch.randn(c, generator=gen, device=dev)
        b = torch.randn(c, generator=gen, device=dev)
        ok, err = within(group_norm_leaky(x, g, b),
                         group_norm_leaky_plain(x, g, b), BF16_RTOL, 1e-5)
        log("kernel_check", kernel="B1", shape=list(shape), dtype="bf16",
            max_abs_err=err, rtol=BF16_RTOL, atol=1e-5, ok=ok)
        if not ok:
            raise AssertionError(f"B1 disagrees with its plain version at "
                                 f"{shape}: max abs err {err}")
        worst = max(worst, err)
        gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
        k = cuda_ms(lambda: group_norm_leaky(x, g, b))
        p = cuda_ms(lambda: group_norm_leaky_plain(x, g, b))
        lib = cuda_ms(lambda: F.leaky_relu(F.group_norm(x, 8, gb, bb), 0.2))
        bnd, bound_by = bound_ms(2 * x.numel() * x.element_size(),
                                 10 * x.numel(), torch.bfloat16)
        log("kernel_time", kernel="B1", shape=list(shape), sites=count,
            kernel_ms=k, plain_ms=p, library_ms=lib, bound_ms=bnd)
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("bound_ms", bnd)):
            tot[key] += count * v
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
        k = cuda_ms(lambda: conv3x3(x, w))
        p = cuda_ms(lambda: conv3x3_plain(x, w))
        lib = cuda_ms(lambda: F.conv2d(x, w, padding=1))
        out_numel = BATCH * co * hr * hr
        bnd, bound_by = bound_ms(
            (x.numel() + w.numel() + out_numel) * 2,
            2.0 * out_numel * 9 * ci, torch.bfloat16)
        log("kernel_time", kernel="B3", shape=list(x.shape), cout=co,
            kernel_ms=k, plain_ms=p, library_ms=lib, bound_ms=bnd)
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("bound_ms", bnd)):
            tot[key] += v
    return {**tot, "max_abs_err": worst, "bound_by": bound_by}


def check_b2(dev, gen) -> dict:
    hr = 2 * LR
    a = torch.rand((1, hr, hr), generator=gen, device=dev)
    b = (a + 0.05 * torch.randn((1, hr, hr), generator=gen,
                                device=dev)).clamp(0, 1)
    got, want = ssim_per_sample(a, b), ssim_per_sample_plain(a, b)
    ok, err = within(got, want, 0.0, 1e-5)
    log("kernel_check", kernel="B2", shape=list(a.shape), dtype="fp32",
        max_abs_err=err, atol=1e-5, ssim=float(got[0]), ok=ok)
    if not ok:
        raise AssertionError(f"B2 disagrees with its plain version: "
                             f"{float(got[0])} vs {float(want[0])}")
    k = cuda_ms(lambda: ssim_per_sample(a, b))
    p = cuda_ms(lambda: ssim_per_sample_plain(a, b))
    # per pixel: 3 products, 2 x 11 taps x 5 maps x 2, ~18 for the map
    bnd, bound_by = bound_ms(2 * a.numel() * 4 + 4, 241.0 * a.numel(),
                             torch.float32)
    log("kernel_time", kernel="B2", shape=list(a.shape), kernel_ms=k,
        plain_ms=p, library_ms=None, bound_ms=bnd)
    return {"ms": k, "plain_ms": p, "library_ms": None, "bound_ms": bnd,
            "max_abs_err": err, "bound_by": bound_by}


def phantom_batch(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Smooth synthetic slices in [0, 1]: a few random ellipses."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size - 0.5
    out = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(6):
            cy, cx = rng.uniform(-0.3, 0.3, 2)
            ry, rx = rng.uniform(0.05, 0.35, 2)
            out[i] += rng.uniform(0.1, 0.5) * (
                ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0)
    return np.clip(out, 0.0, 1.0)


def main_path(dev) -> dict:

    cfg = ModelConfig(base_filters=BASE_FILTERS)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    engine = InferenceEngine(cfg, params, bf16=True, device=dev)
    rng = np.random.default_rng(0)
    lr = phantom_batch(rng, BATCH, LR)
    hr = phantom_batch(np.random.default_rng(0), BATCH, 2 * LR)
    engine.upscale_batch(lr[:2])                    # load the library, warm

    kernels.reset_launch_counts()
    out = engine.upscale_batch(lr)
    metrics = engine.calculate_metrics(out[0], hr[0], dev)
    counts = kernels.launch_counts()
    log("main_path", slices=BATCH, input=[LR, LR], output=list(out.shape[1:]),
        params=param_count(engine.model), launches=counts, metrics=metrics)
    if out.shape != (BATCH, 2 * LR, 2 * LR) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"bad output: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    want = {"group_norm_leaky": 20, "conv3x3": 2, "ssim_per_sample": 1}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")

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
    return counts


def main() -> int:
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
    regs = [ln.strip() for ln in (_build.BUILD_DIR / "build.log").read_text()
            .splitlines() if "registers" in ln or "spill" in ln]
    log("build", seconds=time.perf_counter() - t0, library=str(lib),
        ptxas=regs[:24])

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"B1": check_b1(dev, gen), "B3": check_b3(dev, gen),
               "B2": check_b2(dev, gen)}
    counts = main_path(dev)

    meta = {
        "B1": ("group_norm_leaky", "mri_superresolution_torch/csrc/"
               "groupnorm_leaky.cu", "mri_superresolution_tpu/experiments/"
               "groupnorm_pallas.py:167"),
        "B2": ("ssim_per_sample", "mri_superresolution_torch/csrc/"
               "ssim_fused.cu", "mri_superresolution_tpu/experiments/"
               "ssim_pallas.py:75"),
        "B3": ("conv3x3", "mri_superresolution_torch/csrc/"
               "conv3x3_narrow.cu", "mri_superresolution_tpu/experiments/"
               "conv_pallas.py:107"),
    }
    rows = []
    for key in ("B1", "B2", "B3"):
        name, source, replaces = meta[key]
        r = results[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
