"""The port's phase-space algebra (``experiments/phase.py``) and
``UNetSuperRes(phase_final=True)`` against the JAX package's, on the CPU,
at the tolerances of tests/test_phase.py. The port's tensors are NCHW in
the same c-major phase order (PixelShuffle's); the JAX ones NHWC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.experiments import phase as jphase
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_torch.experiments import phase
from mri_superresolution_torch.kernels import group_norm_leaky
from mri_superresolution_torch.models import unet as unet_mod
from mri_superresolution_torch.models.unet import UNetSuperRes
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)


def _t(x_nhwc):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _np(x_nchw):
    return x_nchw.permute(0, 2, 3, 1).detach().numpy()


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio)).permute(3, 2, 0, 1)


def test_space_to_depth_and_back_match_jax(rng):
    x = rng.random((2, 8, 12, 3), np.float32)
    t = phase.space_to_depth(_t(x))
    assert t.shape == (2, 12, 4, 6)
    np.testing.assert_array_equal(_np(t),
                                  np.asarray(jphase.space_to_depth(x)))
    np.testing.assert_array_equal(_np(phase.depth_to_space(t)), x)
    np.testing.assert_array_equal(
        _np(phase.depth_to_space(t)),
        np.asarray(jphase.depth_to_space(jphase.space_to_depth(x))))


def test_phase_kernels_and_conv_match_jax(rng):
    """The rescattered kernels equal JAX's; the 2x2 conv, its alignment
    and the misaligned collapse match JAX's and the dense 3x3 conv within
    1e-5 (tests/test_phase.py's bar)."""
    x = rng.random((2, 10, 14, 3), np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    k2 = phase.phase_kernel_2x2(_oihw(w))
    np.testing.assert_array_equal(k2.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jphase.phase_kernel_2x2(w)))
    z = phase.phase_conv_2x2(phase.space_to_depth(_t(x)), k2)
    assert z.shape == (2, 20, 6, 8)
    jz = jphase.phase_conv_2x2(jphase.space_to_depth(x),
                               jphase.phase_kernel_2x2(w))
    np.testing.assert_allclose(_np(z), np.asarray(jz), rtol=1e-5, atol=1e-5)
    dense = torch.nn.functional.conv2d(_t(x), _oihw(w), padding=1)
    np.testing.assert_allclose(
        _np(phase.depth_to_space(phase.align_phase(z))), _np(dense),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(phase.align_phase(z)),
                                  np.asarray(jphase.align_phase(
                                      np.asarray(_np(z)))))
    np.testing.assert_allclose(_np(phase.depth_to_space_rev_crop(z)),
                               _np(dense), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        _np(phase.depth_to_space_rev_crop(z)),
        np.asarray(jphase.depth_to_space_rev_crop(_np(z))))
    w1 = rng.standard_normal((1, 1, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        phase.phase_kernel_1x1(_oihw(w1)).permute(2, 3, 1, 0).numpy(),
        np.asarray(jphase.phase_kernel_1x1(w1)))


def test_upsample_bilinear_phases_matches_jax(rng):
    x = rng.random((2, 7, 9, 3), np.float32)
    got = _np(phase.upsample_bilinear_phases(_t(x)))
    np.testing.assert_allclose(got,
                               np.asarray(jphase.upsample_bilinear_phases(x)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase_group_norms_match_jax(rng, dtype):
    """Aligned and misaligned phase GroupNorm against JAX's (fp32: rtol and
    atol 2e-5, tests/test_phase.py's bar; bf16: one bf16 ulp of the
    output, atol 1.6e-2 at |y| <= 2); on a misaligned grid the port's
    statistics come from the valid views alone, as JAX's do (the border
    takes other values, later cropped). The aligned norm is B1's
    arithmetic: ``group_norm_leaky`` with the affine repeated 4x equals
    LeakyReLU of it."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    x = rng.random((2, 8, 8, 16), np.float32)
    scale = rng.random(4, np.float32) + 0.5
    bias = rng.standard_normal(4).astype(np.float32)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else \
        dict(rtol=0, atol=1.6e-2)
    got = phase.phase_group_norm(_t(x).to(tdt), torch.from_numpy(scale),
                                 torch.from_numpy(bias), 2, dtype=tdt)
    want = jphase.phase_group_norm(jnp.asarray(x, jdt), scale, bias, 2,
                                   dtype=jdt)
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want, np.float32), **tol)
    b1 = group_norm_leaky(_t(x).contiguous(memory_format=torch.channels_last),
                          torch.from_numpy(np.repeat(scale, 4)),
                          torch.from_numpy(np.repeat(bias, 4)), n_groups=2)
    np.testing.assert_allclose(
        _np(b1), _np(torch.nn.functional.leaky_relu(
            phase.phase_group_norm(_t(x), torch.from_numpy(scale),
                                   torch.from_numpy(bias), 2), 0.2)),
        rtol=2e-5, atol=2e-5)
    z = rng.random((2, 7, 9, 32), np.float32)
    s8 = rng.random(8, np.float32) + 0.5
    b8 = rng.standard_normal(8).astype(np.float32)
    got = phase.phase_group_norm_misaligned(
        _t(z).to(tdt), torch.from_numpy(s8), torch.from_numpy(b8), 8,
        dtype=tdt)
    want = jphase.phase_group_norm_misaligned(jnp.asarray(z, jdt), s8, b8, 8,
                                              dtype=jdt)
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's init of the phase_final unet (the same tree as the dense
    one) at base filters 16."""
    return jax.tree_util.tree_map(np.asarray, init_params(
        JaxUNet(base_filters=16, phase_final=True), jax.random.key(0),
        (24, 16)))


def _port(params, dtype=torch.float32, phase_final=True):
    m = UNetSuperRes(base_filters=16, dtype=dtype, phase_final=phase_final)
    m.load_state_dict(state_dict_from_jax(params))
    return m


def test_phase_final_fp32_matches_dense_and_jax(jax_params, rng,
                                                monkeypatch):
    """fp32: the port's phase_final forward within rtol 1e-4 / atol 1e-5
    of its dense forward and of JAX's phase_final, with the same
    state_dict; the two aligned norms run on B1's wrapper (at 4 x f/2
    channels, H x W), and B3 does not run."""
    x = rng.random((2, 24, 16, 1), np.float32)
    calls = []
    real = unet_mod.group_norm_leaky

    def spy(t, *a, **k):
        calls.append(tuple(t.shape))
        return real(t, *a, **k)

    monkeypatch.setattr(unet_mod, "group_norm_leaky", spy)
    monkeypatch.setattr(unet_mod, "conv3x3", None)   # not on this path
    with torch.no_grad():
        got = _port(jax_params)(torch.from_numpy(x)).numpy()
    assert len(calls) == 19 and calls.count((2, 32, 24, 16)) == 2
    monkeypatch.undo()
    with torch.no_grad():
        dense = _port(jax_params, phase_final=False)(
            torch.from_numpy(x)).numpy()
    want = np.asarray(JaxUNet(base_filters=16, phase_final=True).apply(
        {"params": jax_params}, x))
    assert got.shape == want.shape == (2, 48, 32, 1)
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_phase_final_bf16_matches_dense_and_jax(jax_params, rng):
    """bf16: within atol 3e-2 of the port's dense bf16 forward
    (tests/test_phase.py's bar within one framework), and against JAX's
    bf16 phase_final within the cross-package bf16 budget of
    tests/test_torch_unet.py (PSNR against one ground truth within 0.1
    dB, SSIM within 1e-3)."""
    from mri_superresolution_tpu.ops import metrics as jmetrics
    from mri_superresolution_tpu.ops.ssim import ssim as jax_ssim
    x = rng.random((2, 16, 16, 1), np.float32)
    gt = jnp.asarray(rng.random((2, 32, 32, 1), np.float32))
    with torch.no_grad():
        got = _port(jax_params, torch.bfloat16)(torch.from_numpy(x)).numpy()
        dense = _port(jax_params, torch.bfloat16, False)(
            torch.from_numpy(x)).numpy()
    want = JaxUNet(base_filters=16, phase_final=True,
                   dtype=jnp.bfloat16).apply({"params": jax_params}, x)
    np.testing.assert_allclose(got, dense, atol=3e-2)
    got = jnp.asarray(got)
    assert abs(float(jmetrics.psnr(got, gt))
               - float(jmetrics.psnr(want, gt))) <= 0.1
    assert abs(float(jax_ssim(got, gt)) - float(jax_ssim(want, gt))) <= 1e-3


def test_phase_final_gradients_reach_every_final_stage_parameter(jax_params,
                                                                 rng):
    """Autograd through the rescatter, alignment and phase norms (B1's
    backward for the aligned two): every final-stage parameter gets a
    finite, non-zero gradient, within rtol 1e-3 / atol 1e-5 of its
    largest entry of the dense model's."""
    x = torch.from_numpy(rng.random((1, 16, 16, 1), np.float32))
    grads = {}
    for pf in (True, False):
        m = _port(jax_params, phase_final=pf)
        m(x).square().mean().backward()
        grads[pf] = {k: p.grad for k, p in m.named_parameters()}
    final = [k for k in grads[True]
             if k.startswith(("final_", "alpha"))]
    assert len(final) == 13
    for k in final:
        g = grads[True][k]
        assert torch.isfinite(g).all() and (g != 0).any(), k
        np.testing.assert_allclose(
            g.numpy(), grads[False][k].numpy(), rtol=1e-3,
            atol=1e-5 * float(grads[False][k].abs().max()), err_msg=k)
