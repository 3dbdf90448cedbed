"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a GPU. On a machine with one (the
JAX package need not be installed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The first test to run builds the kernels (``build/torch_kernels/``).
"""

import numpy as np
import pytest
import torch

from mri_superresolution_torch import kernels
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer import InferenceEngine
from mri_superresolution_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
from mri_superresolution_torch.kernels.groupnorm import (
    gn_quantize, group_norm_leaky, group_norm_leaky_plain, onepass_plan)
from mri_superresolution_torch.kernels.leaky_quantize import (
    leaky_quantize, leaky_quantize_generic, leaky_quantize_plain)
from mri_superresolution_torch.kernels.roll_probe import (
    roll32, roll32_plain, roll_copy, roll_copy_plain, taps3, taps3_plain)
from mri_superresolution_torch.kernels.ssim import (
    ssim_fused, ssim_per_sample, ssim_per_sample_plain)
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.ops.ssim import ssim as ssim_plain

pytestmark = pytest.mark.cuda

BF16_RTOL = 2.0 ** -7      # one bf16 ulp, relative


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # fp32 references in full fp32 (cuDNN convs default to TF32)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = old


def _close(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    rtol, atol = (BF16_RTOL, 1e-5) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _cl(shape, dtype, dev, gen, offset=0):
    """A channels_last (B, C, H, W) tensor; ``offset`` elements into its
    buffer (a non-zero offset breaks 16-byte alignment)."""
    b, c, h, w = shape
    buf = torch.randn(b * c * h * w + offset, generator=gen, device=dev)
    return buf.to(dtype)[offset:].view(b, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape,dtype,offset", [
    ((2, 16, 16, 16), torch.float32, 0),       # 4-wide loads
    ((2, 16, 16, 16), torch.bfloat16, 0),      # 8-wide loads
    ((2, 24, 9, 7), torch.bfloat16, 0),        # 3 vectors a pixel
    ((1, 24, 5, 11), torch.float32, 0),        # groups of 3 across vectors
    ((2, 16, 16, 16), torch.bfloat16, 1),      # unaligned: scalar loads
    ((1, 16, 512, 512), torch.bfloat16, 0),    # batch-1 final-stage site
    ((3, 256, 32, 32), torch.bfloat16, 0),
])
@pytest.mark.parametrize("with_res", [False, True])
def test_group_norm_leaky_kernel(dev, shape, dtype, offset, with_res):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _cl(shape, dtype, dev, gen, offset)
    assert x.is_contiguous(memory_format=torch.channels_last)
    c = shape[1]
    g = torch.randn(c, generator=gen, device=dev)
    b = torch.randn(c, generator=gen, device=dev)
    res = _cl(shape, dtype, dev, gen) if with_res else None
    before = group_norm_leaky.launches
    got = group_norm_leaky(x, g, b, residual=res)
    assert group_norm_leaky.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got, group_norm_leaky_plain(x, g, b, residual=res), dtype)


def _gn_case(shape, dtype, dev, gen, with_res, offset=0):
    c = shape[1]
    x = _cl(shape, dtype, dev, gen, offset)
    g = torch.randn(c, generator=gen, device=dev)
    b = torch.randn(c, generator=gen, device=dev)
    res = _cl(shape, dtype, dev, gen) if with_res else None
    return x, g, b, res


# the unet's five GroupNorm shapes at batch 16 (base_filters 32, 256^2 in),
# and the final stage at batch 1
@pytest.mark.parametrize("shape", [
    (16, 32, 256, 256), (16, 64, 128, 128), (16, 128, 64, 64),
    (16, 256, 32, 32), (16, 16, 512, 512), (1, 16, 512, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_res", [False, True])
def test_group_norm_leaky_onepass(dev, shape, dtype, with_res):
    gen = torch.Generator(device=dev).manual_seed(6)
    x, g, b, res = _gn_case(shape, dtype, dev, gen, with_res)
    assert onepass_plan(x, torch.empty_like(x), res) is not None
    before = (group_norm_leaky.launches, group_norm_leaky.onepass_launches)
    got = group_norm_leaky(x, g, b, residual=res)
    assert (group_norm_leaky.launches,
            group_norm_leaky.onepass_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got, group_norm_leaky_plain(x, g, b, residual=res), dtype)
    # fixed-order sums: the same bits on every run
    assert torch.equal(got, group_norm_leaky(x, g, b, residual=res))


@pytest.mark.parametrize("shape,offset", [
    ((2, 16, 64, 64), 1),              # an offset view: not 16-byte aligned
    ((1, 32, 1024, 1024), 0),          # 64 MiB: more than the SMs can stage
])
def test_group_norm_leaky_twopass_route(dev, shape, offset):
    gen = torch.Generator(device=dev).manual_seed(7)
    x, g, b, res = _gn_case(shape, torch.bfloat16, dev, gen, True, offset)
    assert onepass_plan(x, torch.empty_like(x), res) is None
    before = (group_norm_leaky.launches, group_norm_leaky.onepass_launches)
    got = group_norm_leaky(x, g, b, residual=res)
    assert (group_norm_leaky.launches,
            group_norm_leaky.onepass_launches) == (before[0] + 1, before[1])
    _close(got, group_norm_leaky_plain(x, g, b, residual=res), torch.bfloat16)


def test_group_norm_leaky_onepass_in_cuda_graph(dev):
    gen = torch.Generator(device=dev).manual_seed(8)
    x, g, b, res = _gn_case((16, 32, 64, 64), torch.bfloat16, dev, gen, True)
    group_norm_leaky(x, g, b, residual=res)     # once outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group_norm_leaky(x, g, b, residual=res)
    for seed in (9, 10):
        x.copy_(_cl(x.shape, x.dtype, dev,
                    torch.Generator(device=dev).manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, group_norm_leaky_plain(x, g, b, residual=res),
               torch.bfloat16)
    first = out.clone()
    graph.replay()
    assert torch.equal(out, first)


def test_group_norm_leaky_kernel_refuses_nchw(dev):
    x = torch.randn(1, 16, 8, 8, device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        group_norm_leaky(x, torch.ones(16, device=dev),
                         torch.zeros(16, device=dev))


@pytest.mark.parametrize("b,ci,co,h,w,dtype", [
    (2, 32, 16, 27, 35, torch.bfloat16),       # final_up_conv, odd size
    (2, 16, 16, 64, 48, torch.bfloat16),       # final_conv1
    (1, 3, 8, 17, 9, torch.float32),           # Ci below one chunk
    (1, 40, 64, 20, 33, torch.float32),        # ragged Ci chunk, widest Co
    (1, 16, 24, 8, 8, torch.bfloat16),
    # the bf16 tensor-core kernel
    (1, 3, 16, 17, 9, torch.bfloat16),         # Ci % 8 != 0: element loads
    (1, 40, 16, 20, 33, torch.bfloat16),       # two chunks, second ragged
    (2, 16, 8, 27, 35, torch.bfloat16),        # one n8 fragment
    (1, 32, 24, 33, 70, torch.bfloat16),       # odd n8 count, ragged 33x70
    (1, 40, 64, 20, 33, torch.bfloat16),       # widest Co: 8-row tiles
    (1, 16, 16, 33, 70, torch.bfloat16),       # ragged 33x70
    (1, 32, 16, 512, 512, torch.bfloat16),     # a full-width unet image
])
def test_conv3x3_kernel(dev, b, ci, co, h, w, dtype):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = _cl((b, ci, h, w), dtype, dev, gen)
    wt = (torch.randn((co, ci, 3, 3), generator=gen, device=dev)
          / (9 * ci) ** 0.5).to(dtype)
    got = conv3x3(x, wt)
    assert got.shape == (b, co, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = conv3x3_plain(x, wt)
    if dtype == torch.bfloat16:
        _close(got, want, dtype)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_conv3x3_kernel_unaligned_input(dev):
    """x one element off 16-byte alignment: the bf16 kernel's element
    loads."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = _cl((2, 32, 19, 21), torch.bfloat16, dev, gen, offset=1)
    assert x.data_ptr() % 16 != 0
    wt = (torch.randn((16, 32, 3, 3), generator=gen, device=dev)
          / 17.0).to(torch.bfloat16)
    _close(conv3x3(x, wt), conv3x3_plain(x, wt), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_counts_each_launch(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _cl((1, 16, 8, 8), dtype, dev, gen)
    wt = torch.randn((16, 16, 3, 3), generator=gen, device=dev).to(dtype)
    before = conv3x3.launches
    conv3x3(x, wt)
    assert conv3x3.launches == before + 1
    conv3x3(x, wt)
    assert conv3x3.launches == before + 2


def _ssim_pair(shape, dev, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(shape, generator=gen, device=dev)
    b = (a + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    return a, b


@pytest.mark.parametrize("shape,window", [((3, 27, 35), 11),
                                          ((2, 512, 512), 11),
                                          ((1, 40, 33), 7),
                                          ((8, 512, 512), 11),
                                          ((16, 512, 512), 11),
                                          ((1, 1, 1), 11),
                                          ((2, 17, 600), 11),
                                          ((2, 17, 600), 15),
                                          ((3, 70, 130), 15),
                                          ((2, 9, 21), 1)])
def test_ssim_kernel(dev, shape, window):
    a, b = _ssim_pair(shape, dev)
    before = ssim_per_sample.launches
    got = ssim_per_sample(a, b, window_size=window)
    assert ssim_per_sample.launches == before + 1
    torch.testing.assert_close(
        got, ssim_per_sample_plain(a, b, window_size=window), rtol=0,
        atol=1e-5)
    # fixed-order reductions: the same bits on every run
    assert torch.equal(got, ssim_per_sample(a, b, window_size=window))


def test_ssim_kernel_other_sigma_range_and_types(dev):
    a, b = _ssim_pair((2, 64, 80), dev, seed=3)
    a, b = 255 * a, 255 * b
    got = ssim_per_sample(a, b, window_size=9, sigma=2.0, val_range=255.0)
    torch.testing.assert_close(
        got, ssim_per_sample_plain(a, b, window_size=9, sigma=2.0,
                                   val_range=255.0), rtol=0, atol=1e-5)
    # bf16 inputs are cast to float32 first, as the JAX kernel casts them
    a16, b16 = (a / 255).bfloat16(), (b / 255).bfloat16()
    assert torch.equal(ssim_per_sample(a16, b16),
                       ssim_per_sample(a16.float(), b16.float()))


def test_ssim_kernel_in_cuda_graph(dev):
    """The per-image counters are left at zero by each launch, so graph
    replays give the same bits as eager calls."""
    a, b = _ssim_pair((8, 512, 512), dev, seed=4)
    eager = ssim_per_sample(a, b)            # once outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssim_per_sample(a, b)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    a2, b2 = _ssim_pair((8, 512, 512), dev, seed=5)
    a.copy_(a2)
    b.copy_(b2)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ssim_per_sample_plain(a2, b2), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 512, 512), (8, 512, 512)])
def test_ssim_kernel_is_one_device_kernel(dev, shape):
    a, b = _ssim_pair(shape, dev, seed=6)
    ssim_per_sample(a, b)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ssim_per_sample(a, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "ssim" in names[0], names


def test_ssim_fused_grads_on_card(dev):
    a, b = _ssim_pair((4, 96, 80), dev, seed=7)
    x1, x2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = ssim_per_sample.launches
    val = ssim_fused(x1, x2)
    assert ssim_per_sample.launches == before + 1
    val.backward()
    y1, y2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = ssim_plain(y1[..., None], y2[..., None])
    want.backward()
    torch.testing.assert_close(val, want.detach(), rtol=0, atol=1e-5)
    # the same backward (autograd of the plain version) on the same inputs;
    # cuDNN may sum the depthwise weight gradients in another order
    torch.testing.assert_close(x1.grad, y1.grad, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(x2.grad, y2.grad, rtol=1e-5, atol=1e-8)


def test_unet_on_card_matches_cpu(dev):
    params = build_model(ModelConfig(base_filters=16),
                         generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    x = np.random.default_rng(0).random((2, 27, 35)).astype(np.float32)
    cfg = ModelConfig(base_filters=16)
    gpu = InferenceEngine(cfg, params, bf16=False, device=dev)
    cpu = InferenceEngine(cfg, params, bf16=False, device="cpu")
    kernels.reset_launch_counts()
    got = gpu.upscale_batch(x)
    assert kernels.launch_counts() == {
        "group_norm_leaky": 20, "conv3x3": 2, "ssim_per_sample": 0,
        "leaky_quantize": 0, "gn_quantize": 0, "roll_copy": 0, "roll32": 0,
        "taps3": 0}
    np.testing.assert_allclose(got, cpu.upscale_batch(x), rtol=1e-4,
                               atol=1e-4)
    m = InferenceEngine.calculate_metrics(got[0], got[1], dev)
    assert kernels.launch_counts()["ssim_per_sample"] == 1
    mc = InferenceEngine.calculate_metrics(got[0], got[1], "cpu")
    for k in m:
        assert abs(m[k] - mc[k]) <= 1e-5, k


def test_engine_packs_on_card(dev):
    params = build_model(ModelConfig(base_filters=16),
                         generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    x = np.random.default_rng(1).random((3, 32, 24)).astype(np.float32)
    eng = InferenceEngine(ModelConfig(base_filters=16), params,
                          out_dtype="uint8", device=dev)
    y = eng.upscale_batch(x)
    assert y.shape == (3, 64, 48) and y.dtype == np.uint8


@pytest.mark.parametrize("shape,dtype,offset", [
    ((2, 16, 9, 7), torch.bfloat16, 0),        # 16-byte loads
    ((2, 3, 5, 7), torch.bfloat16, 0),         # odd C, odd size: scalar
    ((1, 12, 8, 6), torch.bfloat16, 0),        # C not a multiple of 8
    ((2, 1, 32, 32), torch.bfloat16, 0),       # inc.conv1's C = 1
    ((2, 16, 8, 8), torch.bfloat16, 3),        # unaligned x: scalar
    ((2, 12, 8, 8), torch.float32, 0),         # fp32, 4-wide loads
    ((1, 5, 7, 3), torch.float32, 1),
    ((16, 32, 256, 256), torch.bfloat16, 0),   # a full-width site
])
@pytest.mark.parametrize("slope", [0.2, 1.0])
def test_leaky_quantize_kernel(dev, shape, dtype, offset, slope):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _cl(shape, dtype, dev, gen, offset)
    assert x.is_contiguous(memory_format=torch.channels_last)
    c = shape[1]
    s = (torch.rand(c, generator=gen, device=dev) + 0.1) / 60
    before = leaky_quantize.launches
    got = leaky_quantize(x, s, slope)
    assert leaky_quantize.launches == before + 1
    assert got.dtype == torch.int8
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = leaky_quantize_plain(x, s, slope)
    # code for code, saturated codes included
    assert torch.equal(got, want)
    assert int((want.abs() == 127).sum()) > 0


# classes of per-channel scales for the exhaustive cases: 1.0, amax /
# 127-like values, non-powers of two near both ends of [2^-64, 2^64] (the
# stream kernel's reciprocal route), extremes outside it (its IEEE division)
_SCALES = (1.0, 0.0123, 3.7 / 127, 1e-30, 1e30, 1.0 / 3.0, 7.1e-20, 5.5e18)
_IN_RANGE = [2.0 ** -64 <= s <= 2.0 ** 64 for s in _SCALES]


def _every_bf16(c, dev, offset=0, cls=0):
    """(1, c, 256, 256) bf16, channels_last, ``offset`` elements into its
    buffer: every finite bf16 code (65,280) in every channel, the channel's
    codes rotated by its index, and the 256 spare pixels zero; scales
    differ from channel to channel. Each group of 16 channels (one stream
    thread's) takes one class of scale, class ``cls`` for the first group,
    so that a thread whose scales all lie in [2^-64, 2^64] runs the
    reciprocal route rather than the IEEE division."""
    codes = torch.arange(65536, dtype=torch.int32)
    bits = (codes << 16).view(torch.float32)
    finite = torch.cat([bits[torch.isfinite(bits)], torch.zeros(256)])
    cols = torch.stack([finite.roll(17 * k) for k in range(c)], dim=1)
    buf = torch.zeros(cols.numel() + offset, dtype=torch.bfloat16)
    buf[offset:] = cols.reshape(-1).to(torch.bfloat16)
    x = buf.to(dev)[offset:].view(1, 256, 256, c).permute(0, 3, 1, 2)
    s = torch.tensor([_SCALES[(k // 16 + cls) % len(_SCALES)] * (1 + k / 997)
                      for k in range(c)], dtype=torch.float32, device=dev)
    return x, s


@pytest.mark.parametrize("c,route,cls", [
    *((1, "stream", cls) for cls in range(len(_SCALES))),
    *((16, "stream", cls) for cls in range(len(_SCALES))),
    (256, "stream", 0), (24, "element", 0)])
@pytest.mark.parametrize("slope", [0.2, 1.0])
def test_leaky_quantize_every_bf16_code(dev, c, route, cls, slope):
    x, s = _every_bf16(c, dev, cls=cls)
    if c in (16, 256):
        # the groups whose threads take the reciprocal route: all or none
        # at C = 16, 12 of the 16 at C = 256
        a = s.abs().cpu().view(-1, 16)
        fast = int(((a >= 2.0 ** -64) & (a <= 2.0 ** 64)).all(dim=1).sum())
        assert fast == {16: int(_IN_RANGE[cls]), 256: 12}[c]
    want = leaky_quantize_plain(x, s, slope)
    before = (leaky_quantize.launches, leaky_quantize.stream_launches)
    got = leaky_quantize(x, s, slope)
    stream = int(route == "stream")
    assert (leaky_quantize.launches, leaky_quantize.stream_launches) == (
        before[0] + 1, before[1] + stream)
    assert torch.equal(got, want)
    assert torch.equal(got, leaky_quantize(x, s, slope))
    # the element kernel on the same codes
    assert torch.equal(leaky_quantize_generic(x, s, slope), want)


@pytest.mark.parametrize("slope", [0.2, 1.0])
def test_leaky_quantize_every_bf16_code_offset_view(dev, slope):
    x, s = _every_bf16(16, dev, offset=3)
    assert x.data_ptr() % 16 != 0
    before = leaky_quantize.stream_launches
    got = leaky_quantize(x, s, slope)
    assert leaky_quantize.stream_launches == before
    assert torch.equal(got, leaky_quantize_plain(x, s, slope))


def _gn_quant_case(shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, g, b, _ = _gn_case(shape, torch.bfloat16, dev, gen, False)
    # calibration-like scales of the GroupNorm's output, a little short so
    # that some codes saturate
    y = group_norm_leaky(x, g, b, negative_slope=1.0)
    s = (y.float().abs().amax(dim=(0, 2, 3)) / 140.0).contiguous()
    return x, g, b, s


# the unet's DoubleConv conv2 shapes at batch 16 (base_filters 32, 256^2
# in): inc and up3, down1 and up2, down2 and up1, down3; and batch 1
@pytest.mark.parametrize("shape", [
    (16, 32, 256, 256), (16, 64, 128, 128), (16, 128, 64, 64),
    (16, 256, 32, 32), (1, 32, 256, 256)])
def test_gn_quantize_matches_composition(dev, shape):
    x, g, b, s = _gn_quant_case(shape, dev, 11)
    assert onepass_plan(x, torch.empty(shape, dtype=torch.int8,
                                       device=dev)) is not None
    want = leaky_quantize_plain(group_norm_leaky(x, g, b, negative_slope=1.0),
                                s, 0.2)
    before = (gn_quantize.launches, group_norm_leaky.launches,
              leaky_quantize.launches)
    got = gn_quantize(x, g, b, s)
    assert (gn_quantize.launches, group_norm_leaky.launches,
            leaky_quantize.launches) == (before[0] + 1, before[1], before[2])
    assert got.dtype == torch.int8
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    assert int((got.abs() == 127).sum()) > 0
    # fixed-order sums: the same bits on every run
    assert torch.equal(got, gn_quantize(x, g, b, s))


def test_gn_quantize_twopass_shape_runs_two_kernels(dev):
    x, g, b, s = _gn_quant_case((1, 32, 1024, 1024), dev, 12)
    before = (gn_quantize.launches, group_norm_leaky.launches,
              leaky_quantize.stream_launches)
    got = gn_quantize(x, g, b, s)
    assert (gn_quantize.launches, group_norm_leaky.launches,
            leaky_quantize.stream_launches) == (before[0], before[1] + 1,
                                                before[2] + 1)
    assert torch.equal(got, leaky_quantize_plain(
        group_norm_leaky(x, g, b, negative_slope=1.0), s, 0.2))


def test_gn_quantize_in_cuda_graph(dev):
    x, g, b, s = _gn_quant_case((16, 64, 64, 64), dev, 13)
    gn_quantize(x, g, b, s)                   # once outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gn_quantize(x, g, b, s)
    for seed in (14, 15):
        x.copy_(_cl(x.shape, x.dtype, dev,
                    torch.Generator(device=dev).manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, leaky_quantize_plain(
            group_norm_leaky(x, g, b, negative_slope=1.0), s, 0.2))
    first = out.clone()
    graph.replay()
    assert torch.equal(out, first)


def test_int8_forward_kernels_match_plain_quantize(dev, monkeypatch):
    """The int8 unet forward with its 20 quantize sites on the kernels
    against the same forward with them on the plain versions (the fused
    sites' reference keeps B1's kernel): the same output, bit for bit."""
    cfg = ModelConfig(base_filters=16)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).to(dev).state_dict()
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 48, 48, 1), np.float32)).to(dev)
    _, amax = quant_forward.build_calib_forward()(params, x)
    scales = quant_forward.scales_from_amax(
        {k: v.cpu().numpy() for k, v in amax.items()})
    fwd = quant_forward.build_int8_forward(params, scales)
    kernels.reset_launch_counts()
    got = fwd(params, x)
    assert (kernels.leaky_quantize.stream_launches,
            kernels.launch_counts()["gn_quantize"]) == (13, 7)

    def gn_quantize_ref(y, g, b, s, slope=0.2, n_groups=8, eps=1e-5):
        return leaky_quantize_plain(
            group_norm_leaky(y, g, b, None, n_groups, 1.0, eps), s, slope)

    monkeypatch.setattr(quant_forward, "leaky_quantize", leaky_quantize_plain)
    monkeypatch.setattr(quant_forward, "gn_quantize", gn_quantize_ref)
    kernels.reset_launch_counts()
    want = fwd(params, x)
    assert (kernels.launch_counts()["leaky_quantize"],
            kernels.launch_counts()["gn_quantize"]) == (0, 0)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,lanes", [(128, 256), (512, 16384), (64, 40)])
def test_roll_probe_kernels(dev, rows, lanes):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((rows, lanes), generator=gen, device=dev).to(
        torch.bfloat16)
    for fn, plain in ((roll_copy, roll_copy_plain), (roll32, roll32_plain),
                      (taps3, taps3_plain)):
        before = fn.launches
        got = fn(x)
        assert fn.launches == before + 1
        assert torch.equal(got, plain(x)), fn.__name__


def test_int8_engine_on_card_follows_the_cpu_state_machine(dev, tmp_path):
    params = build_model(ModelConfig(base_filters=16),
                         generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    cfg = ModelConfig(base_filters=16)
    rng = np.random.default_rng(2)
    batch = rng.random((3, 40, 40), np.float32)
    empty = np.zeros((2, 40, 40), np.float32)
    empty[:, 18:20, 18:20] = 1.0
    path = str(tmp_path / "scales.json")
    gpu = InferenceEngine(cfg, params, device=dev, quant="int8",
                          quant_calib_slices=4, quant_calib_path=path)
    cpu = InferenceEngine(cfg, params, device="cpu", quant="int8",
                          quant_calib_slices=4)
    for b in (batch, batch, empty):
        gpu.upscale_batch(b)
        cpu.upscale_batch(b)
        assert gpu._quant_batches == cpu._quant_batches
        assert gpu._calib_seen == cpu._calib_seen
    assert gpu._quant_batches == {"int8": 0, "bf16": 3}
    kernels.reset_launch_counts()
    got = gpu.upscale_batch(batch)
    counts = kernels.launch_counts()
    assert (counts["leaky_quantize"], counts["group_norm_leaky"],
            counts["gn_quantize"], counts["conv3x3"]) == (13, 13, 7, 0)
    assert kernels.leaky_quantize.stream_launches == 13
    assert group_norm_leaky.onepass_launches == 13
    assert gpu._quant_batches["int8"] == 1
    # the CPU port with the card's frozen scales: the bf16 budget
    ref = InferenceEngine(cfg, params, device="cpu", quant="int8",
                          quant_calib_path=path)
    want = ref.upscale_batch(batch)
    assert np.isfinite(got).all() and got.shape == want.shape
    # the JAX package's int8 bound (tests/test_quant.py): bf16 rounds
    # differently in cuDNN and on the CPU, so a few codes move
    assert np.abs(got - want).mean() < 0.05
