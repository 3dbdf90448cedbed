"""Kernel B4's two Hopper routes, on the CPU: the stream kernel's arithmetic
(``csrc/quantize.cuh``) modelled in numpy on every finite bf16 code, the
plain version against its definition and the JAX package on the same codes,
the fused route ``gn_quantize`` (B1's one-pass kernel with an int8 output)
against its composition and the JAX int8 site, and the route chooser.

The kernels themselves are held against these plain versions code for code
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.ops import quant as jquant
from mri_superresolution_tpu.ops.functional import group_norm_leaky_ref
from mri_superresolution_torch import kernels
from mri_superresolution_torch.kernels.groupnorm import (
    gn_quantize, gn_quantize_plain, group_norm_leaky)
from mri_superresolution_torch.kernels.leaky_quantize import (
    STREAM_MAX_C, _route, leaky_quantize, leaky_quantize_plain)

torch.set_num_threads(2)

# 1.0, typical amax / 127 values, extremes that take the IEEE division
# (outside [2^-64, 2^64]), and non-powers of two
SCALES = (1.0, 0.0123, 3.7 / 127, 1e-30, 1e30, 1.0 / 3.0, 7.1e-20, 5.5e18)


def _all_bf16() -> np.ndarray:
    """Every finite bf16 value, as float32."""
    x = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    return x[np.isfinite(x)]


def _as_tensor(xf: np.ndarray) -> torch.Tensor:
    """(1, 1, 1, n) bf16, channels_last (C == 1: the layout is trivial)."""
    return torch.from_numpy(xf).to(torch.bfloat16).view(1, 1, 1, -1)


def _codes_close(got: np.ndarray, want: np.ndarray):
    """The probe's own bound (tools/bench_int8_probe4.py:130), as in
    tests/test_torch_quant.py: codes differ by at most 1, on under 0.5% of
    elements."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d != 0).mean() < 0.005, (d.max(),
                                                      (d != 0).mean())


def _stream_model(xf: np.ndarray, s: float, slope: float) -> np.ndarray:
    """quant_code (csrc/quantize.cuh) in numpy float32: integer round to
    nearest even of x * slope to bf16 where x < 0, r = RN(1 / s) and one
    FMA correction of x * r where |s| lies in [2^-64, 2^64] (an IEEE
    division elsewhere), clamp to +-127, round by adding 1.5 * 2^23, the
    low byte. FMAs are taken in float64: the remainder x - q * s is exact
    there, and the second FMA's sum is rounded twice, which none of these
    inputs exposes."""
    s, slope = np.float32(s), np.float32(slope)
    x = xf.copy()
    neg = x < 0
    u = (x[neg] * slope).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    x[neg] = u.astype(np.uint32).view(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        if 2.0 ** -64 <= abs(s) <= 2.0 ** 64:
            r = np.float32(1.0) / s
            q0 = x * r
            e = (x.astype(np.float64) - q0.astype(np.float64) * float(s)
                 ).astype(np.float32)
            q1 = (e.astype(np.float64) * float(r) + q0).astype(np.float32)
            q = np.where(np.abs(q0) < 2.0 ** 20, q1, q0)
        else:
            q = x / s
    q = np.where(np.isnan(q), np.float32(-127), q)
    t = np.clip(q, -127, 127).astype(np.float32) + np.float32(12582912.0)
    return (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("slope", [0.2, 1.0])
def test_plain_on_every_bf16_code(slope):
    xf = _all_bf16()
    xt = _as_tensor(xf)
    neg = (xt.float() * slope).to(torch.bfloat16).float()
    for s in SCALES:
        st = torch.tensor([s], dtype=torch.float32)
        got = leaky_quantize_plain(xt, st, slope)
        # the definition, spelled out
        y = torch.where(xt.float() < 0, neg, xt.float()) / st
        want = torch.round(y).clamp(-127, 127).to(torch.int8)
        assert torch.equal(got, want), s
        # the stream kernel's arithmetic, code for code
        np.testing.assert_array_equal(got.view(-1).numpy(),
                                      _stream_model(xf, s, slope),
                                      err_msg=str(s))
        # the XLA site the kernel replaces
        jx = jnp.asarray(xf, jnp.bfloat16)
        xla = np.asarray(jquant.quantize_tensor(
            jax.nn.leaky_relu(jx, slope), np.float32(s)))
        _codes_close(got.view(-1).numpy(), xla)


def _gn_inputs(shape, seed):
    """NHWC numpy bf16-valued x, GroupNorm params and int8 scales."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = np.asarray(jnp.asarray(rng.normal(size=shape) * 2 + 0.3,
                               jnp.bfloat16), np.float32)
    g = (rng.random(c) + 0.5).astype(np.float32)
    b = (rng.normal(size=c) * 0.3).astype(np.float32)
    # calibration-like, a little short so that some codes saturate
    s = (np.float32(2.5) + rng.random(c).astype(np.float32)) / np.float32(140)
    return x, g, b, s.astype(np.float32)


# the unet's DoubleConv conv2 channel counts (base filters 16 and 32) at
# narrow sizes
@pytest.mark.parametrize("shape", [(2, 12, 10, 16), (1, 8, 8, 32),
                                   (2, 4, 6, 64), (1, 8, 8, 256)])
def test_gn_quantize_matches_composition_and_jax(shape):
    x, g, b, s = _gn_inputs(shape, seed=shape[-1])
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    gt, bt, st = map(torch.from_numpy, (g, b, s))
    kernels.reset_launch_counts()
    got = gn_quantize(xt, gt, bt, st)
    assert kernels.launch_counts()["gn_quantize"] == 0       # CPU
    assert got.dtype == torch.int8
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = leaky_quantize(group_norm_leaky(xt, gt, bt, negative_slope=1.0),
                          st, 0.2)
    assert torch.equal(got, want)
    assert torch.equal(got, gn_quantize_plain(xt, gt, bt, st))
    assert int((got.abs() == 127).sum()) > 0
    jx = jnp.asarray(x, jnp.bfloat16)
    xla = np.asarray(jquant.quantize_tensor(
        group_norm_leaky_ref(jx, {"scale": jnp.asarray(g),
                                  "bias": jnp.asarray(b)}), s))
    _codes_close(got.permute(0, 2, 3, 1).numpy(), xla)


def test_gn_quantize_checks_its_inputs():
    x = torch.zeros(1, 16, 2, 2, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    one = torch.ones(16)
    with pytest.raises(ValueError, match="scale"):
        gn_quantize(x, one, one, torch.ones(8))
    with pytest.raises(ValueError, match="groups"):
        gn_quantize(x, one, one, one, n_groups=3)


@pytest.mark.parametrize("c,dtype,n,x_off,want", [
    (1, torch.bfloat16, 2 * 64 * 64, 0, ("stream", 16)),       # inc.conv1
    (16, torch.bfloat16, 16 * 9 * 7, 0, ("stream", 16)),
    (256, torch.bfloat16, 2 * 256 * 4, 0, ("stream", 16)),
    (STREAM_MAX_C, torch.bfloat16, STREAM_MAX_C, 0, ("stream", 16)),
    (2 * STREAM_MAX_C, torch.bfloat16, 2 * STREAM_MAX_C, 0, ("element", 8)),
    (3, torch.bfloat16, 3 * 16, 0, ("element", 8)),            # odd C
    (8, torch.bfloat16, 8 * 16, 0, ("stream", 16)),      # final_conv1 at 16
    (24, torch.bfloat16, 24 * 16, 0, ("element", 8)),          # not 2^k
    (1, torch.bfloat16, 2 * 5 * 7, 0, ("element", 1)),         # n % 16
    (16, torch.bfloat16, 16 * 8, 2, ("element", 1)),           # offset view
    (16, torch.bfloat16, 16 * 8, 16, ("stream", 16)),          # aligned view
    (16, torch.float32, 16 * 8, 0, ("element", 4)),            # fp32
    (3, torch.float32, 3 * 5, 0, ("element", 1)),
])
def test_route_chooser(c, dtype, n, x_off, want):
    base = 1 << 20
    assert _route(c, dtype, n, base + x_off, base) == want


def test_route_follows_offset_views():
    """Three elements into a buffer (torch aligns buffers to at least 16
    bytes), x is 6 bytes off: the element kernel, with element loads."""
    buf = torch.zeros(16 * 8 * 8 + 3, dtype=torch.bfloat16)
    x = buf[3:].view(1, 8, 8, 16).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert buf.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 6
    assert _route(16, x.dtype, x.numel(), x.data_ptr(),
                  buf.data_ptr()) == ("element", 1)
    assert _route(16, x.dtype, x.numel(), buf.data_ptr(),
                  buf.data_ptr()) == ("stream", 16)


def test_sass_loop_counts():
    """tools/sass_loops, which counts the kernels' instructions an element
    from cuobjdump's SASS on the card's machine, on a made-up listing."""
    from mri_superresolution_torch.tools.sass_loops import parse, summarize
    sass = """
        Function : _Zk
    .headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00 */
                                                            /* 0x000fe400 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/              @P0 EXIT ;
        /*0030*/                   MUFU.RCP R3, R2 ;
        /*0040*/                   FADD R4, R3, R3 ;
        /*0050*/              @!P1 BRA 0x30 ;
        /*0060*/                   EXIT ;
        /*0070*/                   F2I.S32 R5, R4 ;
        /*0080*/                   BRA 0x80;
        /*0090*/                   NOP;
"""
    funcs = parse(sass)
    assert list(funcs) == ["_Zk"] and len(funcs["_Zk"]) == 10
    got = summarize(funcs["_Zk"])
    assert got["instructions"] == 9 and got["main_path"] == 7
    assert got["main_path_quarter_rate"] == {"MUFU": 1}
    assert got["loops"] == [
        {"from": "0x30", "to": "0x50", "instructions": 3,
         "quarter_rate": {"MUFU": 1}},
        {"from": "0x80", "to": "0x80", "instructions": 1,
         "quarter_rate": {}}]
