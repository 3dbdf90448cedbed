"""The port's int8 serving path (``ops/quant.py``, ``kernels/
leaky_quantize.py``, ``models/quant_forward.py``) against the JAX package,
on the CPU, where kernel B4's wrapper runs its plain version.

The int8 codes of ``quantize_tensor`` and ``weight_qparams`` are exact;
``int8_conv`` accumulates exactly in int32 on both sides. Whole-model int8
forwards with shared scales are held to the bf16 budget: bf16 rounds at
other places in the two packages (the port's GroupNorm kernel adds the
LeakyReLU and residual in fp32 before one cast), so a few int8 codes move.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.models import build_model as jax_build_model
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.ops import quant as jquant
from mri_superresolution_torch.kernels import leaky_quantize
from mri_superresolution_torch.kernels.leaky_quantize import (
    leaky_quantize_plain)
from mri_superresolution_torch.models import UNetSuperRes
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.ops import quant
from mri_superresolution_torch.ops.metrics import psnr
from mri_superresolution_torch.utils.phantom import phantom_batch
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW-indexed channels_last torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def phantom(seed: int, n: int, size: int) -> np.ndarray:
    return phantom_batch(np.random.default_rng(seed), n, size)


@pytest.fixture(scope="module")
def jax_params():
    model = jax_build_model(JaxModelConfig(base_filters=16),
                            dtype=jnp.bfloat16)
    params = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 1)))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _port_sd(jax_params, dtype=torch.bfloat16):
    m = UNetSuperRes(base_filters=16, dtype=dtype)
    m.load_state_dict(state_dict_from_jax(jax_params), strict=True)
    return m.eval()


# ------------------------------------------------------------ ops/quant

@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_tensor_matches_jax(per_channel):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 7, 9, 5)) * 3).astype(np.float32)
    x[0, 0, 0, :] = [-1e3, -0.5, 0.5, 1.5, 1e3]        # saturation, ties
    s = (np.abs(x).max(axis=(0, 1, 2)) / 100.0).astype(np.float32) \
        if per_channel else np.float32(0.01)
    want = np.asarray(jquant.quantize_tensor(jnp.asarray(x), s))
    got = quant.quantize_tensor(_nchw(x), torch.from_numpy(np.asarray(s)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_nhwc(got), want)


def test_quantize_tensor_saturates():
    q = quant.quantize_tensor(torch.tensor([-10.0, -1.0, 0.0, 0.4, 10.0]),
                              0.01)
    assert q.tolist() == [-127, -100, 0, 40, 127]


@pytest.mark.parametrize("act_scale", [False, True])
def test_weight_qparams_matches_jax(act_scale):
    rng = np.random.default_rng(1)
    k = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)     # HWIO
    s = (rng.random(8).astype(np.float32) + 0.05) if act_scale else None
    want_q, want_s = jquant.weight_qparams(jnp.asarray(k), act_scale=s)
    got_q, got_s = quant.weight_qparams(
        torch.from_numpy(k).permute(3, 2, 0, 1),               # OIHW
        act_scale=None if s is None else torch.from_numpy(s))
    assert got_q.dtype == torch.int8 and got_q.shape == (3, 3, 8, 16)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_weight_qparams_zero_channel():
    k = np.random.default_rng(2).normal(size=(3, 3, 4, 3)).astype(np.float32)
    k[..., 1] = 0.0
    want_q, want_s = jquant.weight_qparams(jnp.asarray(k))
    got_q, got_s = quant.weight_qparams(torch.from_numpy(k).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[1] == 1.0 and not got_q[..., 1].any()


@pytest.mark.parametrize("shape,kernel,padding,bias", [
    ((2, 9, 9, 8), (3, 3, 8, 16), 1, False),
    ((2, 10, 7, 1), (3, 3, 1, 16), 1, True),     # inc.conv1: K = 9 -> 16
    ((1, 4, 3, 16), (1, 1, 16, 8), 0, False),     # 12 rows: padded to 17
    ((1, 6, 5, 12), (3, 3, 12, 6), 1, True),      # Cout 6 padded to 8
])
def test_int8_conv_matches_jax(shape, kernel, padding, bias):
    r = np.random.default_rng(3)
    qx = r.integers(-127, 128, shape).astype(np.int8)
    qk = r.integers(-127, 128, kernel).astype(np.int8)
    sk = (r.random(kernel[-1]) + 0.5).astype(np.float32)
    b = r.normal(size=kernel[-1]).astype(np.float32) if bias else None
    want = np.asarray(jquant.int8_conv(
        jnp.asarray(qx), jnp.asarray(qk), jnp.asarray(sk),
        bias=None if b is None else jnp.asarray(b), padding=padding,
        out_dtype=jnp.float32))
    got = quant.int8_conv(_nchw(qx, torch.int8), torch.from_numpy(qk),
                          torch.from_numpy(sk),
                          bias=None if b is None else torch.from_numpy(b),
                          padding=padding, out_dtype=torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # int32 accumulation is exact on both sides (tests/test_quant.py)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6)
    acc = lax.conv_general_dilated(
        jnp.asarray(qx, jnp.int32), jnp.asarray(qk, jnp.int32), (1, 1),
        ((padding, padding), (padding, padding)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    exact = np.asarray(acc, np.float32) * sk + (0.0 if b is None else b)
    np.testing.assert_array_equal(_nhwc(got), exact)


# ------------------------------------------------------------ kernel B4

@pytest.fixture(scope="module")
def probe4():
    """tools/bench_int8_probe4.py, loaded by path and set to interpret
    mode before its first call, as its own --cpu mode runs."""
    spec = importlib.util.spec_from_file_location(
        "bench_int8_probe4", os.path.join(REPO, "tools",
                                          "bench_int8_probe4.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


def _b4_inputs(shape, seed=4):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.random(shape, np.float32) - 0.3, jnp.bfloat16)
    xf = np.asarray(x, np.float32)
    s = (np.maximum(np.abs(xf).max(axis=(0, 1, 2)), 1e-3) / 127.0
         ).astype(np.float32)
    return x, _nchw(xf, torch.bfloat16), s


def _codes_close(got: np.ndarray, want: np.ndarray):
    """The probe's own bound (bench_int8_probe4.py:130): codes differ by at
    most 1, on under 0.5% of elements."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d != 0).mean() < 0.005, (d.max(),
                                                      (d != 0).mean())


@pytest.mark.parametrize("shape", [(2, 32, 24, 16), (1, 64, 8, 32),
                                   (2, 8, 10, 3)])
def test_leaky_quantize_plain_matches_pallas(probe4, shape):
    x, xt, s = _b4_inputs(shape)
    w, c = shape[2], shape[3]
    want = np.asarray(probe4.leaky_quantize_pallas(
        x, jnp.tile(jnp.asarray(s), w), slope=0.2))
    got = leaky_quantize(xt, torch.from_numpy(s), 0.2)
    assert got.dtype == torch.int8
    assert got.is_contiguous(memory_format=torch.channels_last)
    _codes_close(_nhwc(got), want)
    # and against the XLA site the kernel replaces
    xla = np.asarray(jquant.quantize_tensor(jax.nn.leaky_relu(x, 0.2), s))
    _codes_close(_nhwc(got), xla)


def test_leaky_quantize_slope_one_is_quantize_tensor():
    x, xt, s = _b4_inputs((2, 16, 12, 8), seed=5)
    got = leaky_quantize(xt, torch.from_numpy(s), 1.0)
    assert torch.equal(got, quant.quantize_tensor(xt, torch.from_numpy(s)))
    np.testing.assert_array_equal(
        _nhwc(got), np.asarray(jquant.quantize_tensor(x, s)))


def test_leaky_quantize_plain_definition():
    """The plain version is LeakyReLU in bf16 (x * slope rounded to bf16),
    an fp32 division, round half to even, clamp: spelled out here."""
    _, xt, s = _b4_inputs((1, 8, 8, 4), seed=6)
    xf = xt.float()
    neg = (xf * 0.2).to(torch.bfloat16).float()
    y = torch.where(xf < 0, neg, xf) / torch.from_numpy(s).view(1, -1, 1, 1)
    want = torch.round(y).clamp(-127, 127).to(torch.int8)
    assert torch.equal(leaky_quantize_plain(xt, torch.from_numpy(s)), want)


def test_leaky_quantize_checks_its_inputs():
    x = torch.zeros(1, 4, 2, 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        leaky_quantize(x, torch.ones(4))
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="scale"):
        leaky_quantize(x, torch.ones(3))
    with pytest.raises(TypeError):
        leaky_quantize(x.to(torch.float16), torch.ones(4))


# ------------------------------------------------------- quant_forward

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ref_forward_bit_identical_to_model(jax_params, dtype):
    model = _port_sd(jax_params, dtype)
    x = torch.from_numpy(np.random.default_rng(8).random((2, 40, 48, 1),
                                                         np.float32))
    with torch.inference_mode():
        want = model(x)
        assert torch.equal(qf.reference_forward(model.state_dict(), x,
                                                dtype=dtype), want)
        y, amax = qf.build_calib_forward(dtype=dtype)(model.state_dict(), x)
    assert torch.equal(y, want)
    assert len(amax) == 20


@pytest.mark.parametrize("dtype,rtol", [
    (torch.float32, 1e-4),
    # bf16 rounds at other places in the two packages, one bf16 ulp
    # (2^-8 relative) a layer, compounding over up to ~12 layers
    (torch.bfloat16, 5e-2)])
def test_calib_scales_match_jax(jax_params, dtype, rtol):
    x = phantom(0, 2, 40)[..., None]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jqf.calibrate(jax_params, [x], "unet", dtype=jdt)
    with torch.inference_mode():
        _, amax = qf.build_calib_forward(dtype=dtype)(
            _port_sd(jax_params, dtype).state_dict(), torch.from_numpy(x))
    got = qf.scales_from_amax({k: v.numpy() for k, v in amax.items()})
    assert list(got) == list(want) and len(got) == 20
    assert "__out__" not in got
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_quant_sites_match_jax(jax_params):
    sd = _port_sd(jax_params).state_dict()
    got = qf.quant_sites(sd)
    want = jqf.quant_sites(jax_params, "unet")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (site, w), (_, k) in zip(got, want):
        np.testing.assert_array_equal(w.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(k), err_msg=site)


def test_int8_forward_matches_jax_with_shared_scales(jax_params):
    x = phantom(0, 2, 40)[..., None]
    hr = torch.from_numpy(phantom(0, 2, 80)[..., None])
    scales = jqf.calibrate(jax_params, [x], "unet")
    jy = np.asarray(jax.jit(jqf.build_int8_forward(jax_params, scales,
                                                   "unet"))(
        jax_params, jnp.asarray(x)))
    fp32 = np.asarray(jax_build_model(JaxModelConfig(base_filters=16),
                                      dtype=jnp.float32).apply(
        {"params": jax_params}, jnp.asarray(x)))
    sd = _port_sd(jax_params).state_dict()
    with torch.inference_mode():
        y = qf.build_int8_forward(sd, scales)(sd, torch.from_numpy(x))
        ref = qf.reference_forward(sd, torch.from_numpy(x))
    y = y.numpy()
    assert y.shape == jy.shape == (2, 80, 80, 1)
    assert np.isfinite(y).all() and y.min() >= 0.0 and y.max() <= 1.0
    # JAX's own int8 bound against the bf16 forward (tests/test_quant.py)
    assert np.abs(y - ref.numpy()).mean() < 0.05
    assert np.abs(y - jy).mean() < 0.05

    def db(a, b):
        return float(psnr(torch.tensor(np.array(a)),
                          torch.tensor(np.array(b))))

    # the bf16 budget against one ground truth
    assert abs(db(y, hr) - db(jy, hr)) <= 0.1
    # and against the fp32 forward the port is no worse than JAX
    assert db(y, fp32) >= db(jy, fp32) - 0.1


def test_int8_weights_need_every_scale(jax_params):
    sd = _port_sd(jax_params).state_dict()
    with pytest.raises(ValueError, match="missing"):
        qf.build_int8_forward(sd, {"inc.conv1": np.ones(1, np.float32)})


def test_only_unet_is_supported():
    """The quantized forward takes every family of the JAX package, and
    no other type."""
    assert qf.supported_types() == sorted(jqf.supported_types()) == [
        "edsr", "simple", "unet", "unet_tpu"]
    assert all(qf.supported(t) for t in qf.supported_types())
    assert not qf.supported("nope")
    with pytest.raises(ValueError, match="no quantized forward"):
        qf.quant_sites({}, "nope")


# ------------------------------------------------------------- sidecars

def test_sidecars_cross_read(tmp_path, jax_params):
    scales = jqf.calibrate(jax_params, [phantom(1, 1, 32)[..., None]],
                           "unet")
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jqf.save_scales(jpath, scales, "unet")
    got, mtype = qf.load_scales(jpath)
    assert mtype == "unet" and list(got) == list(scales)
    for k in scales:
        np.testing.assert_array_equal(got[k], np.asarray(scales[k]))
    qf.save_scales(ppath, got, "unet")
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    back, mtype = jqf.load_scales(ppath)
    assert mtype == "unet"
    for k in scales:
        np.testing.assert_array_equal(back[k], np.asarray(scales[k]))


def test_load_scales_rejects_foreign_json(tmp_path):
    path = tmp_path / "not_scales.json"
    path.write_text(json.dumps({"hello": 1}))
    with pytest.raises(ValueError, match="scales file"):
        qf.load_scales(str(path))
