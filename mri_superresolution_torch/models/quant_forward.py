"""Functional model-zoo forwards with int8 post-training quantization.

An own port of the JAX package's ``models/quant_forward.py`` for the four
families (``unet``, ``unet_tpu``, ``edsr``, ``simple``). It takes the
port's state_dict (fp32 tensors on the serving device) and runs every conv
site in one of four modes that share one code path:

- ``ref``       the bf16 forward with the module's functions and kernels
                in the same order. On the CPU it is bit-identical to the
                module's forward (tests/test_torch_quant.py and
                tests/test_torch_zoo.py assert it there). On the card it
                is not for edsr: its served trunk runs the bias, ReLU,
                res_scale and residual of a conv as one rounding in
                kernel E (``kernels/bias_epilogue.py``), and ``ref``
                keeps them as separate ops;
- ``calib``     ``ref`` plus each conv input's per-channel max |x| (or its
                ``percentile``), from which the static activation scales
                come;
- ``int8``      s8 x s8 -> s32 convs (``ops/quant.int8_conv``) with the
                per-input-channel activation scales folded into per-Cout
                weight scales;
- ``fakequant`` quantization-aware training (:func:`build_fakequant_forward`):
                ``ref``'s dataflow, every quantized site's input and weight
                through the float simulation of ``int8``
                (``ops/quant.fake_quant_*``) with straight-through
                gradients. It runs the kernels ``ref`` runs (B1 forward,
                and its backward under autograd, at every GroupNorm; B3 at
                the unet's two narrow sites), not the int8 routes.

The output head (site ``__out__``: the unet's ``final_conv.3``,
``unet_tpu``'s ``head_out``, edsr's ``tail``, simple's ``reconstruct``)
stays bf16 in every mode, as in the JAX package. In ``int8`` mode every
other site's input goes through kernel B4. At the unet and unet_tpu's
seven DoubleConv ``conv2`` sites it is B4's fused route,
``kernels.gn_quantize``: the GroupNorm before the site (its affine and one
cast to bf16), then the LeakyReLU in bf16 and the quantize, which is the
JAX dataflow (GroupNorm cast to bf16, bf16 leaky_relu, quantize) in one
kernel. Every other site quantizes with ``kernels.leaky_quantize`` at
slope 1.0, a tensor that is already activated (edsr's and simple's ReLU
runs in bf16 before it, as JAX's does). So the unet's ``final_up_conv``
and ``final_conv1`` run int8 there and not on kernel B3. Launches per
forward:

| family | ``ref``/``calib`` | ``int8`` |
| --- | --- | --- |
| unet | B1 20, B3 2 | B1 13, ``gn_quantize`` 7, B4 13 |
| unet_tpu | B1 20 | B1 13, ``gn_quantize`` 7, B4 13 |
| edsr (8 blocks) | none | B4 18 |
| simple | none | B4 2 |

Calibration sidecars (``save_scales``/``load_scales``, format
``int8-ptq-scales-v1``) are byte-compatible with the JAX package's, so each
package reads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import (conv3x3, gn_quantize,
                                               group_norm_leaky,
                                               leaky_quantize)
from mri_superresolution_torch.models.unet import CL, _conv, _upsample2
from mri_superresolution_torch.ops.functional import (GN_EPS, max_pool2,
                                                      pixel_shuffle)
from mri_superresolution_torch.ops.normalize import _percentile_weights
from mri_superresolution_torch.ops.quant import (FOREGROUND_INTENSITY,
                                                 fake_quant_act,
                                                 fake_quant_kernel, int8_conv,
                                                 ste, weight_qparams)
from mri_superresolution_torch.utils.weights import edsr_num_blocks

SCALES_FORMAT = "int8-ptq-scales-v1"
_SLOPE = 0.2
_GROUPS = 8
OUT_SITE = "__out__"


class _Ctx:
    """Per-forward context: mode, frozen scales and int8 weights, the
    statistics this forward records, the calibration percentile and, in
    ``fakequant``, the (B, 1, 1, 1) mask of the samples that quantize."""

    def __init__(self, mode: str = "ref", scales=None, qweights=None,
                 percentile: float = 100.0, fg_mask=None):
        if mode not in ("ref", "calib", "int8", "fakequant"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.scales = scales or {}
        self.qweights = qweights or {}
        self.amax: Dict[str, torch.Tensor] = {}
        self.percentile = percentile
        self.fg_mask = fg_mask


def _channel_percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q, axis=0)`` of an (N, C) fp32 matrix, rounded as
    XLA rounds it (``ops/normalize._percentile_weights``)."""
    s = torch.sort(a, dim=0).values
    low, high, w_low, w_high = _percentile_weights(q, s.shape[0])
    return (s[low].double() * w_low + (s[high] * w_high).double()).float()


def _gn(sd, prefix, x, residual=None):
    return group_norm_leaky(x, sd[f"{prefix}.weight"], sd[f"{prefix}.bias"],
                            residual=residual, n_groups=_GROUPS,
                            negative_slope=_SLOPE, eps=GN_EPS)


def _int8_site(ctx, site, q, dtype, bias=None, padding=1):
    """The int8 conv at ``site`` on its quantized input ``q``."""
    qk, sk = ctx.qweights[site]
    return int8_conv(q, qk, sk, bias=bias, padding=padding, out_dtype=dtype)


def _fakequant(ctx, site, x, weight):
    """QAT at ``site``: the int8 arithmetic simulated in float (the site's
    per-input-channel activation scale folded into per-Cout weight
    quantization) with straight-through gradients, on the samples of
    ``ctx.fg_mask``; the others keep their full-precision input, as the
    engine serves a near-empty batch in bf16. Records the site's
    per-channel max |x| over those samples (zeros when there are none).
    Returns the (input, weight) the conv then runs on."""
    ax = x.detach().float().abs()
    if ctx.fg_mask is not None:
        ax = torch.where(ctx.fg_mask, ax, 0.0)
    ctx.amax[site] = ax.amax(dim=(0, 2, 3))
    s_a = ctx.scales[site]
    xq = ste(x, fake_quant_act(x, s_a))
    if ctx.fg_mask is not None:
        xq = torch.where(ctx.fg_mask, xq, x)
    return xq, ste(weight, fake_quant_kernel(weight, s_a))


def _site(ctx, site, x, weight, dtype, bias=None, padding=1, narrow=False):
    """The conv at ``site`` on its input ``x``; ``narrow`` sites run kernel
    B3 in bf16 (padding 1, no bias)."""
    if ctx.mode == "int8" and site != OUT_SITE:
        q = leaky_quantize(x.contiguous(memory_format=CL), ctx.scales[site],
                           1.0)
        return _int8_site(ctx, site, q, x.dtype, bias, padding)
    if ctx.mode == "fakequant" and site in ctx.scales:
        x, weight = _fakequant(ctx, site, x, weight)
    if ctx.mode == "calib" and site != OUT_SITE:
        if ctx.percentile < 100.0:
            a = x.detach().float().abs().permute(0, 2, 3, 1).reshape(
                -1, x.shape[1])
            ctx.amax[site] = _channel_percentile(a, ctx.percentile)
        else:
            ctx.amax[site] = x.abs().amax(dim=(0, 2, 3)).float()
    if narrow:
        return conv3x3(x.contiguous(memory_format=CL),
                       weight.to(dtype, memory_format=CL))
    return _conv(x, weight, dtype, bias, padding=padding)


def _double_conv(ctx, sd, site, prefix, x, dtype):
    """DoubleConv (models/unet.py): conv -> GN+leaky -> conv -> GN+leaky,
    the residual added inside the second GN kernel when channels match. In
    int8 mode the first GN+leaky also quantizes conv2's input, in one
    kernel (B4's fused route)."""
    p = f"{prefix}.double_conv"
    y = _site(ctx, f"{site}.conv1", x, sd[f"{p}.0.weight"], dtype)
    conv2 = f"{site}.conv2"
    if ctx.mode == "int8":
        q = gn_quantize(y, sd[f"{p}.1.weight"], sd[f"{p}.1.bias"],
                        ctx.scales[conv2], _SLOPE, n_groups=_GROUPS,
                        eps=GN_EPS)
        y = _int8_site(ctx, conv2, q, y.dtype)
    else:
        y = _site(ctx, conv2, _gn(sd, f"{p}.1", y), sd[f"{p}.3.weight"],
                  dtype)
    res = x if x.shape[1] == y.shape[1] else None
    return _gn(sd, f"{p}.4", y, residual=res)


def _up_block(ctx, sd, i, x1, x2, dtype):
    """Up (models/unet.py): 1x1 conv before the bilinear 2x upsample,
    GN+leaky, pad-to-match, skip concat, DoubleConv."""
    y = _site(ctx, f"up{i}.up_conv", x1, sd[f"up{i}.up.1.weight"], dtype,
              padding=0)
    y = _gn(sd, f"up{i}.up.2", _upsample2(y))
    dy = x2.shape[2] - y.shape[2]
    dx = x2.shape[3] - y.shape[3]
    if dy or dx:
        y = F.pad(y, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    x = torch.cat([x2, y], dim=1).contiguous(memory_format=CL)
    return _double_conv(ctx, sd, f"up{i}.conv", f"up{i}.conv", x, dtype)


def _nchw(x, dtype):
    """(B, H, W, C) input -> NCHW-indexed channels_last in ``dtype``."""
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=CL)


def _head(y):
    """PixelShuffle(2) of the output head, sigmoid in fp32, NHWC."""
    return torch.sigmoid(pixel_shuffle(y, 2).float()).permute(0, 2, 3, 1)


def _backbone(ctx, sd, x, dtype):
    """The unet's encoder-decoder (models/unet.backbone), 17 GN sites."""
    x1 = _double_conv(ctx, sd, "inc", "inc", x, dtype)
    x2 = _double_conv(ctx, sd, "down1", "down1.maxpool_conv.1",
                      max_pool2(x1).contiguous(memory_format=CL), dtype)
    x3 = _double_conv(ctx, sd, "down2", "down2.maxpool_conv.1",
                      max_pool2(x2).contiguous(memory_format=CL), dtype)
    x4 = _double_conv(ctx, sd, "down3", "down3.maxpool_conv.1",
                      max_pool2(x3).contiguous(memory_format=CL), dtype)
    y = _up_block(ctx, sd, 1, x4, x3, dtype)
    y = _up_block(ctx, sd, 2, y, x2, dtype)
    return _up_block(ctx, sd, 3, y, x1, dtype)


def _forward_unet(ctx, sd, x, dtype):
    """Mirrors UNetSuperRes.forward (models/unet.py). x: (B, H, W, 1)."""
    y = _backbone(ctx, sd, _nchw(x, dtype), dtype)

    # dual-branch final 2x upsample
    yb = _site(ctx, "final_up_conv", _upsample2(y),
               sd["final_up_bilinear.1.weight"], dtype, narrow=True)
    yb = _gn(sd, "final_up_bilinear.2", yb)
    yp = _site(ctx, "final_up_pixelshuffle.conv", y,
               sd["final_up_pixelshuffle.conv.weight"], dtype,
               bias=sd["final_up_pixelshuffle.conv.bias"])
    yp = _gn(sd, "final_up_pixelshuffle.norm",
             pixel_shuffle(yp, 2).contiguous(memory_format=CL))
    w = torch.sigmoid(sd["alpha"]).to(dtype).reshape(())
    y = w * yb + (1.0 - w) * yp

    y = _site(ctx, "final_conv1", y.contiguous(memory_format=CL),
              sd["final_conv.0.weight"], dtype, narrow=True)
    y = _gn(sd, "final_conv.1", y)
    # the output head stays bf16 (never quantized), as in the JAX package
    y = _site(ctx, OUT_SITE, y, sd["final_conv.3.weight"], dtype,
              bias=sd["final_conv.3.bias"], padding=0)
    return torch.sigmoid(y.float()).permute(0, 2, 3, 1)


def _forward_unet_tpu(ctx, sd, x, dtype):
    """Mirrors UNetSuperResTPU.forward (models/unet_tpu.py)."""
    y = _backbone(ctx, sd, _nchw(x, dtype), dtype)
    a = _gn(sd, "branch_a_norm", _site(ctx, "branch_a_conv", y,
                                       sd["branch_a_conv.weight"], dtype))
    b = _gn(sd, "branch_b_norm", _site(ctx, "branch_b_conv", y,
                                       sd["branch_b_conv.weight"], dtype,
                                       bias=sd["branch_b_conv.bias"]))
    w = torch.sigmoid(sd["alpha"]).to(dtype).reshape(())
    y = (w * a + (1.0 - w) * b).contiguous(memory_format=CL)
    y = _gn(sd, "head_norm", _site(ctx, "head_conv", y,
                                   sd["head_conv.weight"], dtype))
    return _head(_site(ctx, OUT_SITE, y, sd["head_out.weight"], dtype,
                       bias=sd["head_out.bias"], padding=0))


def _forward_edsr(ctx, sd, x, dtype):
    """Mirrors EDSR.forward (models/edsr.py): conv head, residual blocks
    (conv-ReLU-conv, res_scale 1.0), global skip, the tail (``__out__``).
    ``num_blocks`` is read off the state_dict."""
    def conv(name, t, site=None):
        return _site(ctx, site or name, t, sd[f"{name}.weight"], dtype,
                     bias=sd[f"{name}.bias"])

    head = conv("head", _nchw(x, dtype))
    y = head
    for i in range(edsr_num_blocks(sd)):
        z = F.relu(conv(f"block{i}.conv0", y))
        y = y + 1.0 * conv(f"block{i}.conv1", z)
    y = conv("body_out", y)
    return _head(conv("tail", y + head, OUT_SITE))


def _forward_simple(ctx, sd, x, dtype):
    """Mirrors SimpleSR.forward (models/simple.py): the 9-5-5 trunk, the
    ``reconstruct`` conv the output head."""
    y = F.relu(_site(ctx, "extract", _nchw(x, dtype), sd["extract.weight"],
                     dtype, bias=sd["extract.bias"], padding=4))
    y = F.relu(_site(ctx, "map", y, sd["map.weight"], dtype,
                     bias=sd["map.bias"], padding=2))
    return _head(_site(ctx, OUT_SITE, y, sd["reconstruct.weight"], dtype,
                       bias=sd["reconstruct.bias"], padding=2))


_FORWARDS = {"unet": _forward_unet, "unet_tpu": _forward_unet_tpu,
             "edsr": _forward_edsr, "simple": _forward_simple}


def supported(model_type: str) -> bool:
    return model_type in _FORWARDS


def supported_types():
    """Model types with a quantizable forward."""
    return sorted(_FORWARDS)


def reference_forward(params, x, model_type: str = "unet",
                      dtype=torch.bfloat16) -> torch.Tensor:
    """The bf16 forward: the module's on the CPU, bit for bit (see the
    module docstring for the card)."""
    return _FORWARDS[model_type](_Ctx("ref"), params, x, dtype)


def build_calib_forward(model_type: str = "unet", dtype=torch.bfloat16,
                        percentile: float = 100.0):
    """``fn(params, x) -> (y, amax)``: the exact bf16 forward plus each
    quantizable site's per-input-channel max |x|, or with ``percentile`` <
    100 that percentile of |x| over the batch's pixels (fp32 tensors on x's
    device), so a server can calibrate while it serves bf16."""
    fwd = _FORWARDS[model_type]

    def run(params, x):
        ctx = _Ctx("calib", percentile=percentile)
        y = fwd(ctx, params, x, dtype)
        return y, ctx.amax

    return run


def build_fakequant_forward(model_type: str = "unet", dtype=torch.bfloat16,
                            min_foreground: float = 0.05):
    """The quantization-aware-training forward: ``fn(params, amax, x) ->
    (y, batch_amax, any_fg)``.

    Every site the int8 forward quantizes (all but the output head) runs on
    the float simulation of the int8 arithmetic (``_fakequant``) with the
    scales ``amax / 127`` (1 where amax is 0), so that the weights learn to
    absorb the quantization noise. ``amax`` is the trainer's running
    ``{site: (Cin,)}`` estimate (:func:`calib_amax`'s structure).

    A sample quantizes when at least ``min_foreground`` of its pixels are
    above ``FOREGROUND_INTENSITY``, the engine's routing rule; the others
    keep full-precision activations and stay out of the statistic.
    Quantized, an all-background sample is constant within each GroupNorm
    group at every layer, and its gradient overflows through the
    GroupNorms' 1/sqrt(eps). ``batch_amax`` is the per-site max |x| over
    the quantizing samples, exact zeros when there are none, and
    ``any_fg`` (a bool tensor) says whether there were any: the trainer
    updates its running amax only then, and zeros stay neutral under
    gradient accumulation's max over microbatches. ``params`` is a
    state_dict; with ``model.state_dict(keep_vars=True)`` the gradients
    reach the model's parameters."""
    fwd = _FORWARDS[model_type]

    def run(params, amax, x):
        scales = {}
        for k, v in amax.items():
            v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
            scales[k] = torch.where(v > 0, v / 127.0, torch.ones_like(v))
        fg = (x.float().abs() > FOREGROUND_INTENSITY).float().mean(
            dim=tuple(range(1, x.dim())))
        mask = (fg >= min_foreground).reshape(
            (x.shape[0],) + (1,) * (x.dim() - 1))
        ctx = _Ctx("fakequant", scales=scales, fg_mask=mask)
        y = fwd(ctx, params, x, dtype)
        return y, dict(ctx.amax), mask.any()

    return run


@torch.no_grad()
def calib_amax(params, x, model_type: str = "unet", dtype=torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    """One batch's per-site per-input-channel max |x| through the
    full-precision forward: the start of QAT's running statistic."""
    _, amax = build_calib_forward(model_type, dtype)(params, x)
    return {k: v for k, v in amax.items() if k != OUT_SITE}


def amax_template(params, model_type: str = "unet"
                  ) -> Dict[str, Tuple[int]]:
    """``{site: (Cin,)}``: the shapes of :func:`calib_amax`'s output, from
    the weights' shapes alone (no forward, no device work). The trainer
    checks a restored QAT statistic against it."""
    return {site: (int(w.shape[1]),)
            for site, w in quant_sites(params, model_type)}


@torch.no_grad()
def calibrate(params, batches, model_type: str = "unet",
              dtype=torch.bfloat16, percentile: float = 100.0
              ) -> Dict[str, np.ndarray]:
    """Per-site static activation scales ``{site: (Cin,) clip / 127}`` over
    calibration ``batches`` ((B, H, W, C) float arrays or tensors on the
    params' device), clip the max over the batches of each site's
    per-channel ``percentile`` of |x|. With ``percentile`` < 100 the
    statistic runs over every pixel of a batch: calibrate on unpadded
    inputs, since zero padding pulls a percentile toward 0 (the max, the
    default, is immune to it)."""
    fn = build_calib_forward(model_type, dtype, percentile)
    dev = next(iter(params.values())).device
    amax: Dict[str, np.ndarray] = {}
    for b in batches:
        _, out = fn(params, torch.as_tensor(b, dtype=torch.float32,
                                            device=dev))
        for k, v in out.items():
            v = v.cpu().numpy().astype(np.float32)
            amax[k] = np.maximum(amax[k], v) if k in amax else v
    return scales_from_amax(amax)


def scales_from_amax(amax: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-site, per-input-channel scales amax/127; zero-range channels
    get 1. Sites in sorted order, the order of the JAX package's jitted
    dicts, so the two packages write the same sidecar bytes."""
    return {k: np.where(np.asarray(v) > 0, np.asarray(v) / 127.0,
                        1.0).astype(np.float32)
            for k, v in sorted(amax.items()) if k != OUT_SITE}


def save_scales(path: str, scales: Dict[str, np.ndarray],
                model_type: str) -> None:
    """Write frozen calibration scales as a JSON sidecar (atomic), in the
    JAX package's ``int8-ptq-scales-v1`` format, byte for byte."""
    blob = {"format": SCALES_FORMAT, "model_type": model_type,
            "scales": {k: np.asarray(v, np.float32).tolist()
                       for k, v in scales.items()}}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def load_scales(path: str) -> Tuple[Dict[str, np.ndarray], str]:
    """Read a sidecar written by :func:`save_scales` (either package's) ->
    (scales, model_type)."""
    with open(path) as f:
        blob = json.load(f)
    if blob.get("format") != SCALES_FORMAT:
        raise ValueError(f"{path} is not an int8 PTQ scales file")
    scales = {k: np.asarray(v, np.float32) for k, v in blob["scales"].items()}
    return scales, blob.get("model_type", "unet")


def quant_sites(params, model_type: str = "unet"):
    """``[(site, OIHW weight)]`` for every quantizable conv site (all but
    the output head), in the JAX package's order and names: 20 for the
    unet and unet_tpu, 2 * num_blocks + 2 for edsr, 2 for simple."""
    if not supported(model_type):
        raise ValueError(f"no quantized forward for {model_type!r}")
    sites = []

    def dc(site, prefix):
        sites.append((f"{site}.conv1", params[f"{prefix}.double_conv.0.weight"]))
        sites.append((f"{site}.conv2", params[f"{prefix}.double_conv.3.weight"]))

    if model_type in ("unet", "unet_tpu"):
        dc("inc", "inc")
        for i in (1, 2, 3):
            dc(f"down{i}", f"down{i}.maxpool_conv.1")
        for i in (1, 2, 3):
            sites.append((f"up{i}.up_conv", params[f"up{i}.up.1.weight"]))
            dc(f"up{i}.conv", f"up{i}.conv")
    if model_type == "unet":
        sites.append(("final_up_conv", params["final_up_bilinear.1.weight"]))
        sites.append(("final_up_pixelshuffle.conv",
                      params["final_up_pixelshuffle.conv.weight"]))
        sites.append(("final_conv1", params["final_conv.0.weight"]))
    elif model_type == "unet_tpu":
        for site in ("branch_a_conv", "branch_b_conv", "head_conv"):
            sites.append((site, params[f"{site}.weight"]))
    elif model_type == "edsr":
        names = ["head"] + [f"block{i}.conv{j}"
                            for i in range(edsr_num_blocks(params))
                            for j in (0, 1)] + ["body_out"]
        sites += [(n, params[f"{n}.weight"]) for n in names]
    else:
        sites += [(n, params[f"{n}.weight"]) for n in ("extract", "map")]
    return sites


def int8_qweights(params, scales, model_type: str = "unet"
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every quantizable site's ``(q_kernel HWIO int8, k_scale)`` with its
    per-input-channel activation scale folded in, on the params' device.
    Raises if ``scales`` misses a site."""
    sites = quant_sites(params, model_type)
    missing = [s for s, _ in sites if s not in scales]
    if missing:
        raise ValueError(f"calibration scales missing for sites: {missing}")
    return {site: weight_qparams(w, act_scale=torch.as_tensor(
                np.asarray(scales[site], np.float32), device=w.device))
            for site, w in sites}


def build_int8_forward(params, scales, model_type: str = "unet",
                       dtype=torch.bfloat16):
    """``fn(params, x) -> y`` running every quantizable site in int8 with
    the frozen ``scales`` ({site: (Cin,)}). The int8 weights and the
    device copies of the scales are made here, once."""
    fwd = _FORWARDS[model_type]
    qweights = int8_qweights(params, scales, model_type)
    dev = next(iter(params.values())).device
    act = {site: torch.as_tensor(np.asarray(scales[site], np.float32),
                                 device=dev).contiguous()
           for site in qweights}

    def run(p, x):
        return fwd(_Ctx("int8", scales=act, qweights=qweights), p, x, dtype)

    return run
