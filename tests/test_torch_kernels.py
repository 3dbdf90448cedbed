"""The port's kernel modules (B1 GroupNorm+LeakyReLU, B2 SSIM, B3 narrow
conv) on the CPU, where each wrapper runs its plain PyTorch version, held
against the JAX package's Pallas kernels in interpret mode.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as nn

from mri_superresolution_tpu.experiments.conv_pallas import conv3x3_packed_fwd
from mri_superresolution_tpu.experiments.groupnorm_pallas import (
    fused_group_norm_leaky)
from mri_superresolution_tpu.experiments.ssim_pallas import (
    ssim_fused_per_sample)
from mri_superresolution_tpu.ops.ssim import _gaussian_window_np as jax_window
from mri_superresolution_tpu.ops.ssim import ssim as jax_ssim
from mri_superresolution_tpu.ops.ssim import ssim_map as jax_ssim_map
from mri_superresolution_torch import kernels
from mri_superresolution_torch.kernels.conv3x3 import conv3x3
from mri_superresolution_torch.kernels.groupnorm import (_launch_geometry,
                                                         group_norm_leaky)
from mri_superresolution_torch.kernels.ssim import ssim_per_sample
from mri_superresolution_torch.ops.ssim import (_gaussian_window_np, ssim,
                                                ssim_map)

torch.set_num_threads(2)


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW-indexed channels_last torch tensor."""
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


# ------------------------------------------------------------------ B1

@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 8, 8, 64)])
@pytest.mark.parametrize("with_res", [False, True])
def test_group_norm_leaky_fp32_matches_pallas(shape, with_res):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=shape[-1]).astype(np.float32)
    bias = rng.normal(size=shape[-1]).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32) if with_res else None
    want = np.asarray(fused_group_norm_leaky(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), interpret=True))
    got = group_norm_leaky(_nchw(x), torch.from_numpy(scale),
                           torch.from_numpy(bias),
                           residual=None if res is None else _nchw(res))
    assert got.is_contiguous(memory_format=torch.channels_last)
    # rtol 1e-5; atol 1e-6 for outputs that cancel to near zero
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 8, 8, 64)])
def test_group_norm_leaky_fp32_matches_flax(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=shape[-1]).astype(np.float32)
    bias = rng.normal(size=shape[-1]).astype(np.float32)
    gn = nn.GroupNorm(num_groups=8, epsilon=1e-5)
    want = np.asarray(nn.leaky_relu(gn.apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x)), 0.2))
    got = group_norm_leaky(_nchw(x), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 8, 8, 64)])
@pytest.mark.parametrize("with_res", [False, True])
def test_group_norm_leaky_bf16_within_one_ulp_of_pallas(shape, with_res):
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=shape[-1]).astype(np.float32)
    bias = rng.normal(size=shape[-1]).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32) if with_res else None
    want = np.asarray(fused_group_norm_leaky(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res, jnp.bfloat16),
        interpret=True)).astype(np.float32)
    got = group_norm_leaky(
        _nchw(x, torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(bias),
        residual=None if res is None else _nchw(res, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(_nhwc(got) - want) <= _bf16_ulp(want))


def test_group_norm_leaky_rejects_wrong_layout_and_types():
    x = torch.randn(1, 16, 8, 8)                 # NCHW-contiguous
    s, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="channels_last"):
        group_norm_leaky(x, s, b)
    xc = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="float32"):
        group_norm_leaky(xc, s.double(), b)
    with pytest.raises(TypeError):
        group_norm_leaky(xc.half(), s, b)
    with pytest.raises(ValueError, match="groups"):
        group_norm_leaky(xc[:, :12].contiguous(
            memory_format=torch.channels_last), s[:12], b[:12])


@pytest.mark.parametrize("c,itemsize,vec,threads", [
    (16, 2, 8, 256), (32, 2, 8, 256), (256, 2, 8, 256), (8, 2, 8, 256),
    (16, 4, 4, 256), (24, 2, 8, 192), (12, 4, 4, 192), (16, 2, 1, 256)])
def test_group_norm_launch_geometry(c, itemsize, vec, threads):
    """Thread layout of the CUDA kernel (host side, testable here): vpp
    vectors per pixel times a power of two of rows, vector loads only when
    the channels and pointers allow 16-byte accesses."""
    aligned = vec != 1 or c % (16 // itemsize)
    got_vec, rows, chunk_px, nchunks = _launch_geometry(
        512 * 512, c, itemsize, aligned=bool(aligned) and vec != 1)
    assert got_vec == vec
    assert rows & (rows - 1) == 0
    assert (c // vec) * rows == threads
    assert chunk_px * c <= 16384 and nchunks * chunk_px >= 512 * 512


# ------------------------------------------------------------------ B2

@pytest.mark.parametrize("shape", [(3, 32, 32), (2, 27, 35)])
def test_ssim_per_sample_matches_pallas_and_xla(shape):
    rng = np.random.default_rng(3)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape).astype(np.float32), 0, 1)
    got = ssim_per_sample(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    pallas = np.asarray(ssim_fused_per_sample(jnp.asarray(a), jnp.asarray(b),
                                              interpret=True))
    xla = np.asarray(jax_ssim(jnp.asarray(a)[..., None],
                                jnp.asarray(b)[..., None],
                                size_average=False))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-6)
    got4 = ssim_per_sample(torch.from_numpy(a)[..., None],
                           torch.from_numpy(b)[..., None]).numpy()
    np.testing.assert_array_equal(got4, got)


def test_ssim_plain_functions_match_jax():
    rng = np.random.default_rng(4)
    a = rng.random((2, 20, 24, 1), dtype=np.float32)
    b = rng.random((2, 20, 24, 1), dtype=np.float32)
    w = np.array([1.0, 3.0], np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    # pointwise map: sigma^2 = E[x^2] - mu^2 cancels in fp32 on noise
    # images, so the map is held to atol 1e-5, the means below to 1e-6
    np.testing.assert_allclose(
        ssim_map(ta, tb, window_size=7, sigma=1.0).numpy(),
        np.asarray(jax_ssim_map(jnp.asarray(a), jnp.asarray(b),
                                  window_size=7, sigma=1.0)),
        rtol=0, atol=1e-5)
    assert abs(float(ssim(ta, tb)) - float(jax_ssim(
        jnp.asarray(a), jnp.asarray(b)))) < 1e-6
    assert abs(float(ssim(ta, tb, sample_weights=torch.from_numpy(w)))
               - float(jax_ssim(jnp.asarray(a), jnp.asarray(b),
                                  sample_weights=jnp.asarray(w)))) < 1e-6
    np.testing.assert_array_equal(_gaussian_window_np(11, 1.5),
                                  jax_window(11, 1.5))


def test_ssim_per_sample_rejects_bad_inputs():
    a = torch.rand(1, 16, 16)
    # other float types are cast to float32, as the JAX kernel casts them
    assert torch.equal(ssim_per_sample(a.double(), a.double()),
                       ssim_per_sample(a, a))
    with pytest.raises(ValueError, match="window_size"):
        ssim_per_sample(a, a, window_size=17)
    with pytest.raises(ValueError, match="single-channel"):
        ssim_per_sample(a[..., None].expand(1, 16, 16, 2),
                        a[..., None].expand(1, 16, 16, 2))


# ------------------------------------------------------------------ B3

@pytest.mark.parametrize("ci", [16, 32])
def test_conv3x3_matches_pallas(ci):
    rng = np.random.default_rng(5)
    x = rng.random((1, 16, 16, ci), dtype=np.float32)
    k = rng.normal(0, 0.1, (3, 3, ci, 16)).astype(np.float32)
    want = np.asarray(conv3x3_packed_fwd(jnp.asarray(x), jnp.asarray(k),
                                         h_tile=8, interpret=True))
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = conv3x3(_nchw(x), w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)


def test_conv3x3_rejects_unsupported():
    x = torch.randn(1, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv3x3(x, torch.randn(12, 16, 3, 3))
    with pytest.raises(ValueError, match="multiple of 8"):
        conv3x3(x, torch.randn(72, 16, 3, 3))
    with pytest.raises(ValueError, match="channels_last"):
        conv3x3(torch.randn(1, 16, 8, 8), torch.randn(16, 16, 3, 3))
    with pytest.raises(ValueError, match="dtype"):
        conv3x3(x, torch.randn(16, 16, 3, 3).bfloat16())


def test_cpu_calls_do_not_count_as_launches():
    kernels.reset_launch_counts()
    x = torch.randn(1, 16, 8, 8).contiguous(memory_format=torch.channels_last)
    group_norm_leaky(x, torch.ones(16), torch.zeros(16))
    kernels.group_norm_leaky_backward(x, torch.ones(16), torch.zeros(16), x)
    conv3x3(x, torch.randn(16, 16, 3, 3))
    ssim_per_sample(torch.rand(1, 8, 8), torch.rand(1, 8, 8))
    kernels.leaky_quantize(x, torch.ones(16))
    kernels.gn_quantize(x, torch.ones(16), torch.zeros(16), torch.ones(16))
    p = torch.randn(64, 64).bfloat16()
    for probe in (kernels.roll_copy, kernels.roll32, kernels.taps3):
        probe(p)
    assert kernels.launch_counts() == {
        "group_norm_leaky": 0, "group_norm_leaky_backward": 0,
        "conv3x3": 0, "ssim_per_sample": 0,
        "leaky_quantize": 0, "gn_quantize": 0, "roll_copy": 0, "roll32": 0,
        "taps3": 0}


# ------------------------------------------- the served kernels as operators

def _op_calls():
    """(name, wrapper call, plain result) of each served kernel on one
    small channels_last batch."""
    from mri_superresolution_torch.kernels.groupnorm import (
        gn_quantize_plain, group_norm_leaky_plain)
    from mri_superresolution_torch.kernels.conv3x3 import conv3x3_plain
    from mri_superresolution_torch.kernels.leaky_quantize import (
        leaky_quantize_plain)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 8, 8, generator=g).contiguous(
        memory_format=torch.channels_last)
    s, b = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g)
    q = torch.rand(16, generator=g) * 0.05 + 0.01
    w = torch.randn(8, 16, 3, 3, generator=g)
    return [
        ("group_norm_leaky", lambda t: group_norm_leaky(t, s, b, t),
         group_norm_leaky_plain(x, s, b, x)),
        ("conv3x3", lambda t: conv3x3(t, w), conv3x3_plain(x, w)),
        ("leaky_quantize", lambda t: kernels.leaky_quantize(t, q, 0.2),
         leaky_quantize_plain(x, q, 0.2)),
        ("gn_quantize", lambda t: kernels.gn_quantize(t, s, b, q),
         gn_quantize_plain(x, s, b, q))], x


@pytest.mark.parametrize("i", range(4))
def test_served_kernels_are_dispatcher_operators(i):
    """Each served kernel is ``torch.ops.mri_sr.<name>``. Without a
    gradient to keep, its wrapper gives on the CPU the plain version in
    channels_last memory, as the kernels write it (eagerly it calls the
    operator's implementation directly); ``torch.export`` records the
    operator with a symbolic batch (its fake implementation), and the
    program, which runs the operator, gives the wrapper's bits."""
    calls, x = _op_calls()
    name, call, want = calls[i]
    assert hasattr(torch.ops.mri_sr, name)
    with torch.no_grad():
        got = call(x)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want.contiguous(
        memory_format=torch.channels_last))

    class M(torch.nn.Module):
        def forward(self, t):
            return call(t)

    with torch.no_grad():
        ep = torch.export.export(M(), (x,), dynamic_shapes=(
            {0: torch.export.Dim("batch", min=1)},))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert f"mri_sr.{name}.default" in ops
    out = [n for n in ep.graph.nodes if n.op == "output"][0].args[0][0]
    val = out.meta["val"]
    assert not isinstance(val.shape[0], int)          # the batch symbolic
    assert val.dtype == want.dtype
    x3 = torch.cat([x, x[:1]]).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        assert torch.equal(ep.module()(x3), call(x3))


def test_kernels_with_a_gradient_stay_autograd_functions():
    """Training does not go through the operators: B1 and B3 with inputs
    that require grad run their ``autograd.Function`` and give gradients;
    without, the same values through the operator."""
    calls, x = _op_calls()
    for name, call, _ in calls[:2]:
        xg = x.clone().requires_grad_()
        y = call(xg)
        assert isinstance(y.grad_fn, torch.autograd.function.BackwardCFunction)
        y.float().square().sum().backward()
        assert xg.grad is not None and torch.isfinite(xg.grad).all(), name
        with torch.no_grad():
            assert torch.equal(call(x), y.detach()), name
