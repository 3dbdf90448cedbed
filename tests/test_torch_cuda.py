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
from mri_superresolution_torch.kernels.bias_epilogue import (
    bias_epilogue, bias_epilogue_plain)
from mri_superresolution_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
from mri_superresolution_torch.kernels.groupnorm import (
    gn_quantize, group_norm_leaky, group_norm_leaky_backward,
    group_norm_leaky_backward_fourpass, group_norm_leaky_backward_plain,
    group_norm_leaky_plain, onepass_backward_plan, onepass_plan)
from mri_superresolution_torch.kernels.leaky_quantize import (
    leaky_quantize, leaky_quantize_generic, leaky_quantize_plain)
from mri_superresolution_torch.kernels.roll_probe import (
    roll32, roll32_plain, roll_copy, roll_copy_plain, taps3, taps3_plain)
from mri_superresolution_torch.kernels.ssim import (
    ssim_fused, ssim_per_sample, ssim_per_sample_plain)
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.ops.ssim import ssim as ssim_plain
from mri_superresolution_torch.utils.phantom import phantom_batch

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


def _device_kernels(fn, tries=3):
    """Names of the device kernels one call of ``fn`` runs, from
    ``torch.profiler``. Now and then the profiler records no device event
    at all for a call (seen on the H100 machine); a trace with none is
    taken again, each on one call of its own, up to ``tries`` times."""
    names = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


@pytest.mark.parametrize("shape", [(1, 512, 512), (8, 512, 512)])
def test_ssim_kernel_is_one_device_kernel(dev, shape):
    a, b = _ssim_pair(shape, dev, seed=6)
    ssim_per_sample(a, b)
    names = _device_kernels(lambda: ssim_per_sample(a, b))
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
        "group_norm_leaky": 20, "group_norm_leaky_backward": 0,
        "conv3x3": 2, "ssim_per_sample": 0,
        "leaky_quantize": 0, "gn_quantize": 0, "roll_copy": 0, "roll32": 0,
        "taps3": 0, "bias_epilogue": 0, "window_attention": 0,
        "padded_layer_norm": 0, "swin_mlp": 0}
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


# ------------------------------------------------ training: B1, B2, B3 grads

ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}


def _bwd_close(got, want, dtype):
    """B1 backward's gates: dx within one ulp of x's dtype (relative) plus
    1e-5 absolute, for summation orders that differ where terms cancel;
    dscale, dbias within rtol 1e-4 (plus 1e-4 of their largest entry, for
    sums of ~1e6 terms of either sign)."""
    (dx, ds, db), (wx, ws, wb) = got, want
    assert dx.dtype == wx.dtype == dtype
    assert dx.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(dx.float(), wx.float(), rtol=ULP[dtype],
                               atol=1e-5)
    for a, b in ((ds, ws), (db, wb)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


_BOTH = (torch.bfloat16, torch.float32)


def _bwd_case(shape, dtype, dev, seed, offset=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, g, b, _ = _gn_case(shape, dtype, dev, gen, False, offset)
    gy = _cl(shape, dtype, dev, gen, offset)
    return x, g, b, gy


# the unet's five GroupNorm shapes at the training batch (8 x 128^2 in,
# base_filters 32), then odd ones; `onepass`: the dtypes whose one-pass
# route takes the shape (the rest take the four-pass kernel)
@pytest.mark.parametrize("shape,offset,onepass", [
    ((8, 32, 128, 128), 0, _BOTH), ((8, 64, 64, 64), 0, _BOTH),
    ((8, 128, 32, 32), 0, _BOTH), ((8, 256, 16, 16), 0, _BOTH),
    ((8, 16, 256, 256), 0, _BOTH),      # two waves in bf16, three in fp32
    ((3, 32, 128, 128), 0, _BOTH),      # an odd image count
    ((7, 16, 256, 256), 0, _BOTH),      # waves of 4 and 3: an idle slot
    ((2, 8, 64, 64), 0, _BOTH),         # one group a channel
    ((2, 24, 9, 7), 0, ()),             # 3 vectors a pixel
    ((1, 24, 5, 11), 0, ()),            # groups across vectors
    ((2, 16, 16, 16), 1, ()),           # an offset view: scalar loads
    ((1, 16, 512, 512), 0, (torch.bfloat16,)),  # fp32: too large on chip
    ((2, 512, 8, 8), 0, ())])           # more than 256 channels
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_leaky_backward_kernel(dev, shape, offset, onepass, dtype):
    x, g, b, gy = _bwd_case(shape, dtype, dev, 11, offset)
    dx = torch.empty_like(x)
    assert (onepass_backward_plan(x, gy, dx) is not None) == (
        dtype in onepass and offset == 0)
    before = (group_norm_leaky_backward.launches,
              group_norm_leaky_backward.onepass_launches)
    got = group_norm_leaky_backward(x, g, b, gy)
    assert (group_norm_leaky_backward.launches,
            group_norm_leaky_backward.onepass_launches) == (
        before[0] + 1, before[1] + int(dtype in onepass and offset == 0))
    want = group_norm_leaky_backward_plain(x, g, b, gy)
    _bwd_close(got, want, dtype)
    # fixed-order sums: the same bits on every run
    again = group_norm_leaky_backward(x, g, b, gy)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    # the four-pass kernel, called alone, at every shape
    _bwd_close(group_norm_leaky_backward_fourpass(x, g, b, gy), want, dtype)


@pytest.mark.parametrize("shape", [(8, 16, 256, 256), (8, 256, 16, 16)])
def test_group_norm_leaky_backward_onepass_in_cuda_graph(dev, shape):
    """Captured on a side stream (as autograd's backward of a forward run
    there is), the one-pass backward replays with the eager call's bits,
    so every launch leaves its counters at zero; fed new inputs, a replay
    matches the twin."""
    x, g, b, gy = _bwd_case(shape, torch.bfloat16, dev, 14)
    eager = group_norm_leaky_backward(x, g, b, gy)   # counters made here
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = group_norm_leaky_backward(x, g, b, gy)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(out, eager))
    x2, _, _, gy2 = _bwd_case(shape, torch.bfloat16, dev, 15)
    x.copy_(x2)
    gy.copy_(gy2)
    graph.replay()
    torch.cuda.synchronize()
    _bwd_close(out, group_norm_leaky_backward_plain(x, g, b, gy),
               torch.bfloat16)


@pytest.mark.parametrize("route,kernels_a_call", [
    (group_norm_leaky_backward, 1), (group_norm_leaky_backward_fourpass, 4)])
def test_group_norm_leaky_backward_device_kernels(dev, route,
                                                  kernels_a_call):
    x, g, b, gy = _bwd_case((8, 32, 128, 128), torch.bfloat16, dev, 16)
    route(x, g, b, gy)
    names = _device_kernels(lambda: route(x, g, b, gy))
    assert len(names) == kernels_a_call, names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_res", [False, True])
def test_group_norm_leaky_grads_through_autograd(dev, dtype, with_res):
    """The Function's gradients against torch autograd of the plain
    forward, on the card (relative L2 1e-4: autograd's z rounds in
    another order, which may flip a few masks at z ~ 0)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x, g, b, res = _gn_case((2, 32, 24, 20), dtype, dev, gen, with_res)
    gy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
    leaves = [t for t in (x, g, b, res) if t is not None]
    grads = []
    for fn in (group_norm_leaky, group_norm_leaky_plain):
        ins = [t.detach().clone().requires_grad_() for t in leaves]
        ins[0] = ins[0].detach().contiguous(
            memory_format=torch.channels_last).requires_grad_()
        if with_res:
            ins[3] = ins[3].detach().contiguous(
                memory_format=torch.channels_last).requires_grad_()
        before = group_norm_leaky_backward.launches
        fn(*ins[:3], residual=ins[3] if with_res else None).backward(gy)
        grads.append([t.grad.float() for t in ins])
        if fn is group_norm_leaky:
            assert group_norm_leaky_backward.launches == before + 1
    for got, want in zip(*grads):
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= (1e-2 if dtype == torch.bfloat16 else 1e-4), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ci", [32, 16])
def test_conv3x3_grads_on_card(dev, dtype, ci):
    gen = torch.Generator(device=dev).manual_seed(13)
    x = _cl((2, ci, 40, 36), dtype, dev, gen).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn((16, ci, 3, 3), generator=gen, device=dev) / 12).to(
        dtype)
    gy = torch.randn((2, 16, 40, 36), generator=gen, device=dev).to(dtype)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = conv3x3.launches
    conv3x3(x1, w1).backward(gy)
    assert conv3x3.launches == before + 1
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    torch.nn.functional.conv2d(x2, w2, padding=1).backward(gy)
    # the same library gradients on the same inputs
    tol = dict(rtol=BF16_RTOL, atol=1e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x1.grad, x2.grad, **tol)
    torch.testing.assert_close(w1.grad, w2.grad, **tol)


def test_ssim_per_sample_grads_on_card(dev):
    a, b = _ssim_pair((4, 96, 80), dev, seed=9)
    wv = torch.tensor([1.0, 0.5, 0.0, 2.0], device=dev)
    x1, x2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = ssim_per_sample.launches
    (ssim_per_sample(x1, x2) * wv).sum().backward()
    assert ssim_per_sample.launches == before + 1
    y1, y2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    (ssim_per_sample_plain(y1, y2) * wv).sum().backward()
    torch.testing.assert_close(x1.grad, y1.grad, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(x2.grad, y2.grad, rtol=1e-5, atol=1e-8)


def _unet_grads(device, dtype, sd, lo, hr):
    from mri_superresolution_torch.config import LossConfig
    from mri_superresolution_torch.losses import CombinedLoss
    model = build_model(ModelConfig(base_filters=32), dtype=dtype).to(device)
    model.load_state_dict(sd)
    loss, _ = CombinedLoss(LossConfig())(model(lo.to(device)), hr.to(device))
    loss.backward()
    return float(loss.detach()), {n: p.grad
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_backward_on_card_gives_every_param_a_gradient(dev, dtype):
    """The autograd repair: after loss.backward() on the card every
    parameter has a gradient, close to the CPU port's in the same dtype
    from the same weights and phantom batch, at the unet's full width.
    bf16: every cosine >= 0.99. fp32 without TF32: every gradient within
    5e-2 relative L2, their median within 2e-3; PyTorch's own CUDA and CPU
    ops differ by that much here (with the port's kernels swapped for
    their plain versions and cuDNN off, a median of 8.2e-4 and `alpha` at
    2.7e-2), while a missing or wrong gradient is off by order 1."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sd = build_model(ModelConfig(base_filters=32),
                         generator=torch.Generator().manual_seed(3)
                         ).state_dict()
        lo = torch.from_numpy(phantom_batch(np.random.default_rng(3), 2,
                                            128))[..., None]
        hr = torch.from_numpy(phantom_batch(np.random.default_rng(3), 2,
                                            256))[..., None]
        kernels.reset_launch_counts()
        lg, gg = _unet_grads(dev, dtype, sd, lo, hr)
        counts = kernels.launch_counts()
        assert (counts["group_norm_leaky"], counts["group_norm_leaky_backward"],
                counts["conv3x3"], counts["ssim_per_sample"]) == (20, 20, 2, 1)
        # every GroupNorm site's gradient on the one-pass route
        assert group_norm_leaky_backward.onepass_launches == 20
        lc, gc = _unet_grads("cpu", dtype, sd, lo, hr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert abs(lg - lc) <= (1e-2 if dtype == torch.bfloat16 else 1e-4) * lc
    errs = []
    for name, want in gc.items():
        got = gg[name]
        assert got is not None, name
        got, want = got.cpu().double().flatten(), want.double().flatten()
        if dtype == torch.float32:
            errs.append(float((got - want).norm() / want.norm()))
            assert errs[-1] <= 5e-2, (name, errs[-1])
        else:
            cos = float(got @ want / (got.norm() * want.norm()))
            assert cos >= 0.99, (name, cos)
    if errs:
        assert float(np.median(errs)) <= 2e-3, np.median(errs)


def test_serving_forward_saves_nothing_and_keeps_its_bits(dev):
    """Under no_grad the wrappers call their kernels directly: nothing is
    saved for a backward, the launch counts are serving's, and the output
    has the bits of the differentiable route's forward."""
    sd = build_model(ModelConfig(base_filters=16),
                     generator=torch.Generator().manual_seed(4)).state_dict()
    model = build_model(ModelConfig(base_filters=16), dtype=torch.bfloat16)
    model.load_state_dict(sd)
    model.to(dev)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (2, 32, 32, 1), np.float32)).to(dev)
    saved = []
    kernels.reset_launch_counts()
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        served = model(x)
    counts = kernels.launch_counts()
    assert saved == [] and counts["group_norm_leaky"] == 20 and \
        counts["conv3x3"] == 2 and counts["group_norm_leaky_backward"] == 0
    trained = model(x)
    assert trained.requires_grad and torch.equal(served, trained.detach())


def test_cli_train_one_epoch_on_card(dev, tmp_path, capsys):
    """``python -m mri_superresolution_torch.cli.train`` for one epoch on the
    card: every step through B1 forward and backward, B3 and B2, finite
    losses, best and final checkpoints."""
    import json
    from mri_superresolution_torch import native
    from mri_superresolution_torch.cli import train as cli
    hr = phantom_batch(np.random.default_rng(5), 12, 64)
    lr = phantom_batch(np.random.default_rng(5), 12, 32)
    for sub, imgs in (("hr", hr), ("lr", lr)):
        (tmp_path / sub).mkdir()
        for i, img in enumerate(imgs):
            native.imwrite_gray(str(tmp_path / sub / f"sub-{i}_s{i}.png"),
                                np.round(img * 255).astype(np.uint8))
    kernels.reset_launch_counts()
    final = cli.main(["--full_res_dir", str(tmp_path / "hr"),
                      "--low_res_dir", str(tmp_path / "lr"),
                      "--base_filters", "16", "--batch_size", "4",
                      "--epochs", "1", "--seed", "0",
                      "--checkpoint_dir", str(tmp_path / "ckpt"),
                      "--log_dir", str(tmp_path / "logs")])
    counts = kernels.launch_counts()
    # 12 pairs: 10 train (3 steps), 2 validation (1 batch)
    assert (counts["group_norm_leaky"], counts["group_norm_leaky_backward"],
            counts["conv3x3"], counts["ssim_per_sample"]) == (80, 60, 8, 4)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    summary = [ln for ln in lines if ln["type"] == "epoch_summary"]
    assert len(summary) == 1 and np.isfinite(summary[0]["train_loss"]) and \
        np.isfinite(summary[0]["val_loss"])
    assert final.endswith("final_model_unet.ckpt")
    assert (tmp_path / "ckpt" / "best_model_unet.ckpt").exists()


# ------------------------------------------------ whole-volume serving


def _serving_engine(dev, **kw):
    params = build_model(ModelConfig(base_filters=16),
                         generator=torch.Generator().manual_seed(6)
                         ).state_dict()
    return InferenceEngine(ModelConfig(base_filters=16), params,
                           device=dev, **kw), params


@pytest.mark.parametrize("kw", [{}, {"tta": True},
                                {"normalize_inputs": True,
                                 "transpose_io": True,
                                 "out_dtype": "int16"}],
                         ids=["plain", "tta", "transpose_io"])
def test_upscale_batches_equals_sequential_on_card(dev, kw):
    """The depth-2 window (asynchronous uploads from page-locked buffers,
    fetches on a side stream) yields the bits of map(upscale_batch), with
    every yielded array alive at once and each the sole view of its own
    page-locked buffer."""
    eng, _ = _serving_engine(dev, **kw)
    rng = np.random.default_rng(7)
    shapes = [(4, 64, 64), (3, 48, 64), (4, 64, 64), (1, 64, 64),
              (4, 64, 64)]
    if kw.get("normalize_inputs"):
        batches = [(rng.random(s) * 3000).astype(np.int16) for s in shapes]
    else:
        batches = [rng.random(s, dtype=np.float32) for s in shapes]
    ref = [eng.upscale_batch(b) for b in batches]
    got = list(eng.upscale_batches(iter(batches), depth=2))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
        # the whole of a page-locked buffer of its own
        assert isinstance(g.base, torch.Tensor) and g.base.is_pinned()
        assert g.base.data_ptr() == g.ctypes.data
        assert g.base.untyped_storage().nbytes() == g.nbytes
    assert len({g.ctypes.data for g in got}) == len(got)


def test_pinned_buffers_wait_for_their_copies(dev):
    """An upload's page-locked staging buffer goes back to the allocator
    while its copy is still queued behind a long kernel; the next upload
    must not reuse it before the copy's event has fired. Likewise a fetch
    queued behind the sleep lands whole."""
    eng, _ = _serving_engine(dev)
    a = np.full((4, 256, 256), 1.0, np.float32)
    b = np.full((4, 256, 256), 2.0, np.float32)
    for _ in range(3):
        torch.cuda._sleep(50_000_000)            # ~tens of ms on the stream
        xa = eng._upload(a)
        xb = eng._upload(b)
        torch.cuda.synchronize()
        assert bool((xa == 1.0).all()) and bool((xb == 2.0).all())
    y = torch.full((4, 512, 512), 3.0, device=dev)
    torch.cuda._sleep(50_000_000)
    handle = eng._start_fetch(y * 2)
    del y
    np.testing.assert_array_equal(eng._collect(handle), 6.0)


def test_page_locked_volume_uploads_without_a_host_copy(dev, monkeypatch):
    """Batches that are views of a volume page-locked by ``page_locked``
    upload straight from it, with no staging copy, and give the bits of
    staged uploads of the same batches; the volume is unlocked after."""
    eng, _ = _serving_engine(dev, normalize_inputs=True, transpose_io=True,
                             out_dtype="int16")
    vol = np.asfortranarray(
        (np.random.default_rng(11).random((40, 48, 9)) * 2000).astype(
            np.int16))
    view = vol.T                                  # (9, 48, 40), C-order
    starts = range(0, 9, 4)
    staged = []
    real = InferenceEngine._staged
    monkeypatch.setattr(InferenceEngine, "_staged", staticmethod(
        lambda src: staged.append(src.shape) or real(src)))
    ref = [eng.upscale_batch(view[s:s + 4]) for s in starts]
    assert len(staged) == 3
    with eng.page_locked(view) as locked:
        assert all(torch.from_numpy(locked[s:s + 4]).is_pinned()
                   for s in starts)
        got = list(eng.upscale_batches(locked[s:s + 4] for s in starts))
    assert len(staged) == 3
    assert not torch.from_numpy(view).is_pinned()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_normalized_stack_lands_page_locked(dev):
    """The volume CLI's normalized stack is fetched into page-locked
    memory, which ``page_locked`` then leaves as it is."""
    from mri_superresolution_torch.cli.infer_volume import _normalize_stack
    from mri_superresolution_torch.ops.normalize import normalize_slices
    eng, _ = _serving_engine(dev)
    stack = np.random.default_rng(12).random((5, 32, 40), dtype=np.float32)
    norm = _normalize_stack(stack, dev)
    assert torch.from_numpy(norm).is_pinned()
    np.testing.assert_array_equal(
        norm, normalize_slices(torch.from_numpy(stack).to(dev)).cpu())
    with eng.page_locked(norm) as locked:
        assert locked is norm
        np.testing.assert_array_equal(eng.upscale_batch(locked[:2]),
                                      eng.upscale_batch(np.array(norm[:2])))
    assert torch.from_numpy(norm).is_pinned()


def test_transpose_io_layout_on_card(dev):
    """(N, w, h) raw in, C-contiguous (N, 2w, 2h) out whose .T is the
    F-order volume; the bits of the standard layout on the same card."""
    eng, params = _serving_engine(dev, normalize_inputs=True,
                                  transpose_io=True)
    std = InferenceEngine(ModelConfig(base_filters=16), params, device=dev,
                          normalize_inputs=True)
    raw = (np.random.default_rng(8).random((3, 48, 32)) * 2000).astype(
        np.int16)
    got = eng.upscale_batch(raw)
    assert got.shape == (3, 96, 64) and got.flags.c_contiguous
    assert got.T.flags.f_contiguous
    np.testing.assert_array_equal(
        got.swapaxes(1, 2),
        std.upscale_batch(np.ascontiguousarray(raw.swapaxes(1, 2))))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint16,
                                   np.float32])
def test_raw_upload_and_normalize_on_card(dev, dtype):
    """Raw uint8/int16/uint16/float32 batches are uploaded in their own
    dtype and normalized on the card: the percentiles as the CPU port's,
    and the served batch within the card's fp32 tolerance of it."""
    from mri_superresolution_torch.ops.normalize import normalize_slices
    rng = np.random.default_rng(9)
    hi = 255 if dtype == np.uint8 else 30000
    raw = (rng.random((3, 40, 40)) * hi).astype(dtype)
    eng, params = _serving_engine(dev, normalize_inputs=True, bf16=False)
    x = eng._upload(raw)
    assert x.device.type == "cuda" and x.dtype == torch.from_numpy(raw).dtype
    np.testing.assert_array_equal(x.float().cpu().numpy(),
                                  raw.astype(np.float32))
    torch.testing.assert_close(normalize_slices(x).cpu(),
                               normalize_slices(torch.from_numpy(raw)),
                               rtol=0, atol=0)
    cpu = InferenceEngine(ModelConfig(base_filters=16), params, bf16=False,
                          device="cpu", normalize_inputs=True)
    np.testing.assert_allclose(eng.upscale_batch(raw),
                               cpu.upscale_batch(raw), rtol=1e-4,
                               atol=1e-4)


def test_tta_batch_launches_every_member(dev):
    """One square TTA batch runs 8 forwards on the card: B1 160 times (all
    one-pass), B3 16; a rectangular one 4 forwards."""
    eng, params = _serving_engine(dev, tta=True)
    sq = np.random.default_rng(10).random((2, 64, 64), dtype=np.float32)
    eng.upscale_batch(sq)                                  # warm
    kernels.reset_launch_counts()
    y = eng.upscale_batch(sq)
    counts = kernels.launch_counts()
    assert (counts["group_norm_leaky"], counts["conv3x3"]) == (160, 16)
    assert group_norm_leaky.onepass_launches == 160
    kernels.reset_launch_counts()
    eng.upscale_batch(np.ascontiguousarray(sq[:, :, :48]))
    assert (kernels.launch_counts()["group_norm_leaky"],
            kernels.launch_counts()["conv3x3"]) == (80, 8)
    cpu = InferenceEngine(ModelConfig(base_filters=16), params,
                          device="cpu", tta=True)
    # bf16 on both: the serving budget
    from mri_superresolution_torch.ops.metrics import psnr
    gt = torch.from_numpy(phantom_batch(np.random.default_rng(10), 2, 128))
    c = cpu.upscale_batch(sq)
    d_psnr = abs(float(psnr(torch.from_numpy(y)[..., None], gt[..., None]))
                 - float(psnr(torch.from_numpy(c)[..., None],
                              gt[..., None])))
    assert d_psnr <= 0.1


# ------------------------------------------- the epilogue kernel (EDSR)

_EPI = {"bias": {}, "relu": {"relu": True},
        "residual": {"residual": True, "scale": 1.0},
        "scaled": {"residual": True, "scale": 0.1}}


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("variant", sorted(_EPI))
@pytest.mark.parametrize("shape,dtype", [
    ((1, 64, 27, 35), torch.bfloat16), ((32, 16, 27, 35), torch.bfloat16),
    ((64, 8, 27, 35), torch.bfloat16), ((64, 64, 256, 256), torch.bfloat16),
    ((2, 16, 27, 35), torch.float32), ((3, 8, 27, 35), torch.float32)])
def test_bias_epilogue_kernel(dev, shape, dtype, variant, inplace):
    """Bit for bit the fp32 formula rounded once (the plain version on the
    card), each variant, in place and out of place; the same bits twice."""
    gen = torch.Generator(device=dev).manual_seed(11)
    y, r = _cl(shape, dtype, dev, gen), _cl(shape, dtype, dev, gen)
    b = torch.randn(shape[1], generator=gen, device=dev)
    kw = dict(_EPI[variant])
    if kw.pop("residual", False):
        kw["residual"] = r
    want = bias_epilogue_plain(y, b, **kw)
    again = bias_epilogue(y, b, **kw)
    before = bias_epilogue.launches
    got = bias_epilogue(y, b, inplace=inplace, **kw)
    torch.cuda.synchronize()
    assert bias_epilogue.launches == before + 1
    assert (got is y) == inplace
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want) and torch.equal(again, want)


def test_bias_epilogue_kernel_refuses(dev):
    gen = torch.Generator(device=dev).manual_seed(12)
    y = _cl((2, 16, 8, 8), torch.bfloat16, dev, gen)
    b = torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        bias_epilogue(y.contiguous(), b)
    with pytest.raises(ValueError, match="multiple of 8"):
        bias_epilogue(_cl((2, 12, 8, 8), torch.bfloat16, dev, gen),
                      torch.zeros(12, device=dev))
    with pytest.raises(ValueError, match="16-byte aligned"):
        bias_epilogue(_cl((2, 16, 8, 8), torch.bfloat16, dev, gen, offset=1),
                      b)


def test_edsr_serving_forward_fuses_its_epilogues(dev):
    """EDSR's bf16 forward through the engine takes the epilogue
    2 * num_blocks + 2 times and stays within the serving budget of the
    fp32 CPU forward (0.1 dB PSNR, 1e-3 SSIM against one ground truth); a
    grad-enabled forward on the card launches none and keeps the PyTorch
    ops' bits."""
    from mri_superresolution_torch.ops.metrics import psnr
    cfg = ModelConfig(model_type="edsr", base_filters=64, num_blocks=4)
    model = build_model(cfg, generator=torch.Generator().manual_seed(13))
    g = torch.Generator().manual_seed(14)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    sd = model.state_dict()
    x = phantom_batch(np.random.default_rng(13), 4, 64)
    gt = torch.from_numpy(phantom_batch(np.random.default_rng(13), 4, 128))
    gpu = InferenceEngine(cfg, sd, bf16=True, device=dev)
    cpu = InferenceEngine(cfg, sd, bf16=False, device="cpu")
    gpu.upscale_batch(x[:1])                               # warm
    kernels.reset_launch_counts()
    got = gpu.upscale_batch(x)
    assert kernels.launch_counts() == dict(
        dict.fromkeys(kernels.launch_counts(), 0), bias_epilogue=2 * 4 + 2)
    want = cpu.upscale_batch(x)
    d_psnr = abs(float(psnr(torch.from_numpy(got)[..., None], gt[..., None]))
                 - float(psnr(torch.from_numpy(want)[..., None],
                              gt[..., None])))
    d_ssim = abs(float(ssim_plain(torch.from_numpy(got)[..., None],
                                  gt[..., None]))
                 - float(ssim_plain(torch.from_numpy(want)[..., None],
                                    gt[..., None])))
    assert d_psnr <= 0.1 and d_ssim <= 1e-3, (d_psnr, d_ssim)
    m = build_model(cfg, dtype=torch.bfloat16)
    m.load_state_dict(sd)
    m.to(dev)
    xt = torch.from_numpy(x[..., None]).to(dev)
    kernels.reset_launch_counts()
    trained = m(xt)
    assert trained.requires_grad and bias_epilogue.launches == 0
    with torch.no_grad():
        served = m(xt)
    assert bias_epilogue.launches == 2 * 4 + 2
    torch.testing.assert_close(served, trained.detach(), rtol=0, atol=2e-2)


# ------------------------------------------------------- the model zoo

_ZOO = {"unet_tpu": ({"group_norm_leaky": 20},
                     {"group_norm_leaky": 13, "gn_quantize": 7,
                      "leaky_quantize": 13}),
        "edsr": ({"bias_epilogue": 2 * 2 + 2}, {"leaky_quantize": 6}),
        "simple": ({}, {"leaky_quantize": 2})}


def _counts(**kw):
    want = dict.fromkeys(kernels.launch_counts(), 0)
    want.update(kw)
    return want


@pytest.mark.parametrize("family", sorted(_ZOO))
def test_zoo_forward_on_card_matches_cpu(dev, family):
    """Each family's fp32 forward through the engine on the card against
    the CPU port (cuDNN without TF32), with its launches: unet_tpu B1 20
    and B3 0, edsr the epilogue 2 * 2 + 2, simple none."""
    cfg = ModelConfig(model_type=family, base_filters=16, num_blocks=2)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    x = np.random.default_rng(0).random((2, 27, 35)).astype(np.float32)
    gpu = InferenceEngine(cfg, params, bf16=False, device=dev)
    cpu = InferenceEngine(cfg, params, bf16=False, device="cpu")
    kernels.reset_launch_counts()
    got = gpu.upscale_batch(x)
    assert kernels.launch_counts() == _counts(**_ZOO[family][0])
    np.testing.assert_allclose(got, cpu.upscale_batch(x), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("family", sorted(_ZOO))
def test_zoo_int8_forward_launches_and_matches_plain_quantize(
        dev, family, monkeypatch):
    """Each family's int8 forward on the card: its launches (unet_tpu B1
    13, gn_quantize 7, B4 13 on the stream route; edsr B4 2 * 2 + 2;
    simple B4 2), and the same bits with its quantize sites on the plain
    versions."""
    cfg = ModelConfig(model_type=family, base_filters=16, num_blocks=2)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).to(dev).state_dict()
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 48, 48, 1), np.float32)).to(dev)
    _, amax = quant_forward.build_calib_forward(family)(params, x)
    scales = quant_forward.scales_from_amax(
        {k: v.cpu().numpy() for k, v in amax.items()})
    fwd = quant_forward.build_int8_forward(params, scales, family)
    kernels.reset_launch_counts()
    got = fwd(params, x)
    want_counts = _counts(**_ZOO[family][1])
    assert kernels.launch_counts() == want_counts
    assert kernels.leaky_quantize.stream_launches == \
        want_counts["leaky_quantize"]

    def gn_quantize_ref(y, g, b, s, slope=0.2, n_groups=8, eps=1e-5):
        return leaky_quantize_plain(
            group_norm_leaky(y, g, b, None, n_groups, 1.0, eps), s, slope)

    monkeypatch.setattr(quant_forward, "leaky_quantize", leaky_quantize_plain)
    monkeypatch.setattr(quant_forward, "gn_quantize", gn_quantize_ref)
    want = fwd(params, x)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_perceptual_loss_on_card_matches_cpu(dev):
    """The perceptual term (VGG19 to relu5_4, seeded random weights) and
    its gradient with respect to the output on the card, fp32 without
    TF32, against the CPU (rtol 1e-4, the gradient atol 1e-4 of its
    largest entry)."""
    from mri_superresolution_torch.config import LossConfig
    from mri_superresolution_torch.losses import CombinedLoss
    from mri_superresolution_torch.models import vgg
    params = vgg.random_params(torch.Generator().manual_seed(0), 35)
    cfg = LossConfig(perceptual_weight=0.1)
    rng = np.random.default_rng(0)
    t = rng.random((2, 64, 64, 1), np.float32)
    o = np.clip(t + 0.1 * rng.standard_normal(t.shape), 0, 1).astype(
        np.float32)
    res = []
    for where in (dev, torch.device("cpu")):
        loss = CombinedLoss(cfg, vgg.VGG19Features.from_params(params)
                            .to(where))
        out = torch.tensor(o, device=where, requires_grad=True)
        tot, comps = loss(out, torch.from_numpy(t).to(where))
        tot.backward()
        res.append((float(comps["perceptual_loss"]), float(tot),
                    out.grad.cpu()))
    (pg, tg, gg), (pc, tc, gc) = res
    assert abs(pg - pc) <= 1e-4 * abs(pc) and abs(tg - tc) <= 1e-4 * abs(tc)
    torch.testing.assert_close(gg, gc, rtol=1e-4,
                               atol=1e-4 * float(gc.abs().max()))


def _extract_stack(shape=(6, 90, 70), seed=0):
    """A seeded (n, H, W) float32 stack of anatomy-like slices, non-square
    so that the letterbox pads."""
    return (phantom_batch(np.random.default_rng(seed), shape[0],
                          max(shape[1:]))[:, :shape[1], :shape[2]] * 700.0
            + np.random.default_rng(seed + 1).random(shape) * 30.0
            ).astype(np.float32)


@pytest.mark.parametrize("target", [64, 256])
def test_extract_pipelines_on_card_match_cpu_port(dev, target):
    """The HR and LR pipelines of a stack on the card against the CPU port,
    the LR one with the card's noise draws passed to both: floats within
    1e-5, and the PNG codes identical on at least 99.9% of the pixels and
    never more than one apart."""
    from mri_superresolution_torch.data.extraction import (
        hr_pipeline, lr_pipeline, to_uint8)
    from mri_superresolution_torch.ops.kspace import draw_kspace_noise
    x = torch.from_numpy(_extract_stack())
    noise = draw_kspace_noise(tuple(x.shape),
                              torch.Generator(device=dev).manual_seed(3))
    size = (target, target)
    got = {"hr": hr_pipeline(x.to(dev), size),
           "lr": lr_pipeline(x.to(dev), noise, size)}
    want = {"hr": hr_pipeline(x, size),
            "lr": lr_pipeline(x, tuple(n.cpu() for n in noise), size)}
    for key in got:
        g, w = got[key].cpu(), want[key]
        assert g.device.type == "cpu" and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        d = np.abs(to_uint8(g.numpy()).astype(int)
                   - to_uint8(w.numpy()).astype(int))
        assert (d == 0).mean() >= 0.999 and d.max() <= 1


def test_extract_cli_same_seed_same_pngs_on_card(dev, tmp_path):
    """The extract CLI on the card twice with the same --seed writes the
    same PNG bytes; another seed moves the LR files only."""
    from mri_superresolution_torch import nifti
    from mri_superresolution_torch.cli import extract
    anat = tmp_path / "data" / "set1" / "sub-01" / "anat"
    anat.mkdir(parents=True)
    vol = np.transpose(_extract_stack((12, 90, 70)), (1, 2, 0))
    nifti.save(str(anat / "sub-01_T1w.nii.gz"),
               np.round(vol * 4).astype(np.int16), scl_slope=0.25)
    outs = {}
    for run, seed in (("a", 3), ("b", 3), ("c", 4)):
        rc = extract.main(["--datasets_dir", str(tmp_path / "data"),
                           "--hr_output_dir", str(tmp_path / run / "hr"),
                           "--lr_output_dir", str(tmp_path / run / "lr"),
                           "--n_slices", "5", "--target_size", "64", "64",
                           "--seed", str(seed)])
        assert rc == 0
        outs[run] = {f"{d}/{p.name}": p.read_bytes() for d in ("hr", "lr")
                     for p in sorted((tmp_path / run / d).iterdir())}
    assert len(outs["a"]) == 10 and outs["a"] == outs["b"]
    assert all(outs["c"][k] == v for k, v in outs["a"].items()
               if k.startswith("hr/"))
    assert any(outs["c"][k] != v for k, v in outs["a"].items()
               if k.startswith("lr/"))


def test_metric_suites_launch_b2_once_per_batch(dev):
    """``metric_suites`` of a batch of pairs on the card: one launch of B2
    for the batch, every value within rtol 1e-5 of the CPU port's."""
    from mri_superresolution_torch.ops.metrics import metric_suites
    rng = np.random.default_rng(0)
    o = rng.random((5, 64, 48), np.float32)
    t = np.clip(o + 0.05 * rng.standard_normal(o.shape), 0, 1).astype(
        np.float32)
    kernels.reset_launch_counts()
    got = metric_suites(torch.from_numpy(o).to(dev),
                        torch.from_numpy(t).to(dev))
    assert kernels.launch_counts()["ssim_per_sample"] == 1
    want = metric_suites(torch.from_numpy(o), torch.from_numpy(t))
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-5)


def test_method_metrics_of_a_pair_are_one_b2_launch(dev):
    """The eval CLIs' metrics of the four methods of one pair (256^2):
    one ``metric_suites`` call over their (4, H, W) stack, one launch of
    B2, each method's values within rtol 1e-5 of the CPU port's."""
    from mri_superresolution_torch.cli.test_comparison import method_metrics
    rng = np.random.default_rng(1)
    hr = rng.random((256, 256), np.float32)
    ups = {m: np.clip(hr + s * rng.standard_normal(hr.shape), 0, 1).astype(
        np.float32) for m, s in (("AI Model", 0.02), ("Bilinear", 0.05),
                                 ("Sharp Bilinear", 0.08),
                                 ("Bicubic", 0.04))}
    kernels.reset_launch_counts()
    got = method_metrics(ups, hr, dev)
    assert kernels.launch_counts()["ssim_per_sample"] == 1
    want = method_metrics(ups, hr, torch.device("cpu"))
    assert list(got) == list(want) == list(ups)
    for m, w in want.items():
        for k in w:
            assert got[m][k] == pytest.approx(w[k], rel=1e-5), (m, k)


def test_remat_step_is_bit_equal_on_card_with_its_launches(dev):
    """Two bf16 unet steps (base filters 32, batch 2 of 64^2) with
    ``remat`` give the parameters of the steps without it bit for bit; a
    step launches B1 and B3 twice over (every site's forward again in the
    backward), B1's backward and B2 once."""
    from mri_superresolution_torch.config import LossConfig
    from mri_superresolution_torch.losses import CombinedLoss
    from mri_superresolution_torch.train import trainer
    rng = np.random.default_rng(2)
    batch = {"lr": torch.from_numpy(phantom_batch(rng, 2, 64)[..., None]),
             "hr": torch.from_numpy(phantom_batch(rng, 2, 128)[..., None]),
             "weight": torch.ones(2)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    out = {}
    for remat in (False, True):
        model = build_model(ModelConfig(base_filters=32),
                            dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(0),
                            remat=remat).to(dev)
        state = trainer.TrainState(model, trainer.make_optimizer(
            model.parameters(), 1e-4, 1e-5))
        step = trainer.build_train_step(CombinedLoss(LossConfig()))
        kernels.reset_launch_counts()
        step(state, batch, 1e-4)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        step(state, batch, 1e-4)
        out[remat] = (counts, {k: v.clone() for k, v in
                               model.state_dict().items()})
    assert out[False][0] == {"group_norm_leaky": 20,
                             "group_norm_leaky_backward": 20, "conv3x3": 2,
                             "ssim_per_sample": 1}
    assert out[True][0] == {"group_norm_leaky": 40,
                            "group_norm_leaky_backward": 20, "conv3x3": 4,
                            "ssim_per_sample": 1}
    for k, v in out[False][1].items():
        assert torch.equal(v, out[True][1][k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ema_matches_a_float64_recompute_on_card(dev, dtype):
    """The trainer's in-place EMA (decay 0.9) over 10 steps of the
    full-width unet at 8 x 128^2, fp32 (TF32 off) and bf16, against a
    float64 recompute on the host from each step's live weights: every
    tensor within 1e-6 of its largest magnitude."""
    from mri_superresolution_torch.tools.ema_quality import ema_recompute_gap
    r = ema_recompute_gap(dev, dtype, steps=10, batch=8, lr_hw=128)
    assert r["tensors"] > 0 and r["worst_rel_gap"] <= 1e-6, r


def _qkv(shape, dev, seed=0):
    """A (B, H, W, 3C) bf16 qkv of std 1.5 and a bias table of std 1."""
    b, h, w, c, heads = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = (1.5 * torch.randn(b, h, w, 3 * c, generator=gen, device=dev)
           ).to(torch.bfloat16)
    table = torch.randn(225, heads, generator=gen, device=dev)
    return qkv, table


@pytest.mark.parametrize("shape", [(4, 256, 256, 180, 6),   # SwinIR's
                                   (3, 40, 24, 180, 6),     # odd windows
                                   (2, 16, 32, 36, 3)])     # hd 12
@pytest.mark.parametrize("shift", [0, 4])
def test_window_attention_kernel(dev, shape, shift):
    """The kernel against its plain version computed in bf16 (within one
    bf16 ulp of the largest output) and in fp32 from the same bf16 inputs
    (within 2^-6 of it: the kernel rounds P to bf16); twice the same
    bits."""
    from mri_superresolution_torch.kernels.window_attention import (
        window_attention, window_attention_plain)
    qkv, table = _qkv(shape, dev)
    heads = shape[-1]
    window_attention.launches = 0
    with torch.no_grad():
        got = window_attention(qkv, table, heads, 8, shift)
        again = window_attention(qkv, table, heads, 8, shift)
        want = window_attention_plain(qkv, table, heads, 8, shift)
        want32 = window_attention_plain(qkv.float(), table, heads, 8, shift)
    torch.cuda.synchronize()
    assert window_attention.launches == 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again)
    top = float(want32.abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2 ** -7 * top
    assert float((got.float() - want32).abs().max()) <= 2 ** -6 * top


def test_window_attention_grad_and_cpu_take_the_plain_version(dev):
    from mri_superresolution_torch.kernels.window_attention import (
        window_attention)
    qkv, table = _qkv((1, 16, 16, 36, 3), dev)
    window_attention.launches = 0
    window_attention(qkv.float().requires_grad_(), table, 3, 8, 4)
    window_attention(qkv.float(), table, 3, 8, 4)          # fp32
    window_attention(qkv.cpu(), table.cpu(), 3, 8, 4)
    assert window_attention.launches == 0


@pytest.mark.parametrize("shape", [(4, 256, 256, 180, 6),   # SwinIR's
                                   (3, 40, 24, 180, 6),     # odd windows
                                   (2, 16, 32, 36, 3)])     # rows of 112/40
@pytest.mark.parametrize("shift", [0, 4])
def test_window_attention_kernel_in_16_byte_rows(dev, shape, shift):
    """qkv in rows of 3C rounded up to 8 channels (544 at C = 180, garbage
    past 3C) and the output in rows of C rounded up (184): the first C
    output channels are the kernel's bits on the packed rows, the output's
    pad zero."""
    from mri_superresolution_torch.kernels.window_attention import (
        window_attention)
    b, h, w, c, heads = shape
    qs, os_ = -(-3 * c // 8) * 8, -(-c // 8) * 8
    qkv, table = _qkv(shape, dev)
    wide = torch.full((b, h, w, qs), 9.0, device=dev, dtype=torch.bfloat16)
    wide[..., :3 * c] = qkv
    window_attention.launches = 0
    with torch.no_grad():
        got = window_attention(wide, table, heads, 8, shift, c, os_)
        want = window_attention(qkv, table, heads, 8, shift)
    torch.cuda.synchronize()
    assert window_attention.launches == 2
    assert got.shape == (b, h, w, os_)
    assert torch.equal(got[..., :c], want)
    assert not got[..., c:].any()


@pytest.mark.parametrize("lead,c,cp", [((64, 256, 256), 180, 184),
                                       ((7,), 180, 184), ((4099,), 180, 184),
                                       ((3, 11, 5), 60, 64),
                                       ((333,), 96, 96), ((517,), 240, 240),
                                       ((3,), 500, 512)])
def test_padded_layer_norm_kernel(dev, lead, c, cp):
    """Within one bf16 ulp of the largest output of the plain version
    (fp32 statistics in another order), the pad written as zeros though
    the input's pad holds 7.0, the same bits twice, one launch a call."""
    from mri_superresolution_torch.kernels.padded_layer_norm import (
        padded_layer_norm, padded_layer_norm_plain)
    gen = torch.Generator(device=dev).manual_seed(21)
    x = (0.3 + 2 * torch.randn(*lead, cp, generator=gen, device=dev)
         ).to(torch.bfloat16)
    x[..., c:] = 7.0
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    padded_layer_norm.launches = 0
    with torch.no_grad():
        got = padded_layer_norm(x, w, b, 1e-5)
        again = padded_layer_norm(x, w, b, 1e-5)
        want = padded_layer_norm_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert padded_layer_norm.launches == 2
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, again)
    assert not got[..., c:].any()
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= \
        BF16_RTOL * top


def test_padded_layer_norm_kernel_refuses(dev):
    from mri_superresolution_torch.kernels.padded_layer_norm import (
        padded_layer_norm)
    w, b = torch.ones(180, device=dev), torch.zeros(180, device=dev)
    x = torch.randn(4, 184, device=dev).bfloat16()
    with pytest.raises(ValueError, match="bfloat16"):
        padded_layer_norm(x.float(), w, b, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        padded_layer_norm(torch.randn(4, 180, device=dev).bfloat16(), w, b,
                          1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        padded_layer_norm(torch.randn(4, 192, device=dev).bfloat16()[:, :184],
                          w, b, 1e-5)
    flat = torch.zeros(1 + 4 * 184, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        padded_layer_norm(flat[1:].view(4, 184), w, b, 1e-5)


def _mlp_block(c, hidden, dev, seed=0):
    """norm2, fc1 and fc2 of a Swin block at C = c on the card, at the
    served model's scale (LN scale 1 + N(0, 0.1), fc1 N(0, 1/c), fc2 at
    half the variance-keeping std, biases N(0, 0.1))."""
    gen = torch.Generator().manual_seed(seed)
    norm, fc1, fc2 = torch.nn.LayerNorm(c), torch.nn.Linear(c, hidden), \
        torch.nn.Linear(hidden, c)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
        fc1.weight.copy_(torch.randn(hidden, c, generator=gen) / c ** 0.5)
        fc1.bias.copy_(0.1 * torch.randn(hidden, generator=gen))
        fc2.weight.copy_(0.5 * torch.randn(c, hidden, generator=gen) /
                         hidden ** 0.5)
        fc2.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return norm.to(dev), fc1.to(dev), fc2.to(dev)


@pytest.mark.parametrize("lead,c,cp,hidden", [
    ((4099,), 180, 184, 360),            # ragged: 32 tiles of 128 and 3
    ((16, 256, 256), 180, 184, 360),     # the served stream, 16 slices
    ((3, 11, 5), 180, 184, 100),         # a hidden of 2 chunks, ragged
    ((1000,), 180, 184, 384)])           # the widest hidden, 6 chunks
def test_swin_mlp_kernel(dev, lead, c, cp, hidden):
    """Kernel M against its plain version, the same arithmetic in PyTorch
    (LN, the hidden and the output rounded once each to bf16, fp32 sums in
    another order): within 2 bf16 ulps of the largest output, since each
    side rounds the output once and an LN output or hidden element that
    rounds to its other neighbour moves an output by a small part of an
    ulp. The pad written as zeros though the input's pad holds 7.0, the
    same bits twice, one launch a call, a new tensor (x left as it was)."""
    from mri_superresolution_torch.kernels.swin_mlp import (
        swin_mlp, swin_mlp_plain)
    norm, fc1, fc2 = _mlp_block(c, hidden, dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    x = (0.3 + torch.randn(*lead, cp, generator=gen, device=dev)
         ).to(torch.bfloat16)
    x[..., c:] = 7.0
    kept = x.clone()
    swin_mlp.launches = 0
    with torch.no_grad():
        got = swin_mlp(x, norm, fc1, fc2, c)
        again = swin_mlp(x, norm, fc1, fc2, c)
        want = swin_mlp_plain(x, norm, fc1, fc2, c)
    torch.cuda.synchronize()
    assert swin_mlp.launches == 2
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert got.data_ptr() != x.data_ptr() and torch.equal(x, kept)
    assert torch.equal(got, again)
    assert not got[..., c:].any()
    top = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    print(f"swin_mlp {tuple(lead)} C {c}/{cp} hidden {hidden}: largest gap "
          f"{err / (BF16_RTOL * top):.3f} bf16 ulps of the largest output "
          f"{top:.3f}")
    assert err <= 2 * BF16_RTOL * top


def test_swin_mlp_kernel_refuses(dev):
    """On a CUDA tensor the wrapper launches the kernel or raises: a width
    it has no instance for, fp32, a misaligned start, a gradient."""
    from mri_superresolution_torch.kernels.swin_mlp import swin_mlp
    norm, fc1, fc2 = _mlp_block(180, 360, dev)
    x = torch.randn(4, 184, device=dev).bfloat16()
    swin_mlp.launches = 0
    with torch.no_grad():
        n96, f96, g96 = _mlp_block(90, 180, dev)
        with pytest.raises(ValueError, match="rows of"):
            swin_mlp(torch.randn(4, 96, device=dev).bfloat16(), n96, f96,
                     g96, 90)
        with pytest.raises(ValueError, match="bfloat16"):
            swin_mlp(x.float(), norm, fc1, fc2, 180)
        flat = torch.zeros(1 + 4 * 184, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte aligned"):
            swin_mlp(flat[1:].view(4, 184), norm, fc1, fc2, 180)
    with pytest.raises(RuntimeError, match="no backward"):
        swin_mlp(x, norm, fc1, fc2, 180)
    assert swin_mlp.launches == 0


def test_swinir_served_forward_launches_the_kernel(dev):
    """The published widths' bf16 forward with grad off: W 36 launches,
    the fused MLP half 36 (one a block) and the padded LayerNorm 38 (LN1
    of each block, the patch norm, the final norm), each a span that
    counts its slices or rows, no torch.roll, no softmax (no materialized
    scores), no PyTorch LayerNorm and no GELU; the output within bf16's
    reach of the fp32 forward on the CPU. With grad on, no kernel runs."""
    import time
    from torch.profiler import ProfilerActivity, profile
    from mri_superresolution_torch.kernels.padded_layer_norm import (
        padded_layer_norm)
    from mri_superresolution_torch.kernels.swin_mlp import swin_mlp
    from mri_superresolution_torch.kernels.window_attention import (
        window_attention)
    from mri_superresolution_torch.utils import spans
    cfg = ModelConfig(model_type="swinir", base_filters=180, num_blocks=6)
    model = build_model(cfg, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    params = model.state_dict()
    model = model.to(dev).eval()
    x = torch.rand(2, 36, 44, 1, generator=torch.Generator().manual_seed(1))
    window_attention.launches = 0
    padded_layer_norm.launches = 0
    swin_mlp.launches = 0
    t0 = time.time_ns()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p:
        got = model(x.to(dev))
    torch.cuda.synchronize()
    assert window_attention.launches == 36
    assert swin_mlp.launches == 36
    assert padded_layer_norm.launches == 38
    # each launch's span counts its slices (W) or rows (the LayerNorm, the
    # MLP half) of the frame padded to the window, 40 x 48
    recs = spans.records(t0, time.time_ns())
    assert [r.count for r in recs if r.name == "kernel.window_attention"] \
        == [2] * 36
    assert [r.count for r in recs if r.name == "kernel.swin_layer_norm"] \
        == [2 * 40 * 48] * 38
    assert [r.count for r in recs if r.name == "kernel.swin_mlp"] \
        == [2 * 40 * 48] * 36
    ops = {e.key for e in p.key_averages()}
    assert not ops & {"aten::roll", "aten::softmax", "aten::_softmax",
                      "aten::layer_norm", "aten::native_layer_norm",
                      "aten::gelu"}, ops
    with torch.enable_grad():
        model(x.to(dev))
    assert (window_attention.launches, padded_layer_norm.launches,
            swin_mlp.launches) == (36, 38, 36)
    ref = build_model(cfg)
    ref.load_state_dict(params)
    with torch.no_grad():
        want = ref(x)
    assert got.shape == want.shape == (2, 72, 88, 1)
    gap = float((got.cpu() - want).abs().max())
    assert gap <= 0.05 * float(want.abs().max()), gap


def test_swinir_padded_rows_match_the_unpadded_served_path(dev):
    """The served forward at the published widths in rows of 184 against
    the same bf16 forward in rows of 180 (PyTorch's LayerNorm, the sm80
    GEMMs): outputs clamped to [0, 1] as the engine serves them, within
    the volume cell's limits of the fp32 reference (largest gap 0.025,
    mean 0.005)."""
    cfg = ModelConfig(model_type="swinir", base_filters=180, num_blocks=6)
    model = build_model(cfg, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    model = model.to(dev).eval()
    x = phantom_batch(np.random.default_rng(5), 4, 128)
    x = torch.from_numpy(x[..., None]).to(dev)
    with torch.no_grad():
        assert model.served(x)
        got = model(x).clamp(0, 1)
        want = model._forward(x, False).clamp(0, 1)
    gap = (got - want).abs()
    print(f"padded vs unpadded: max {float(gap.max())}, mean "
          f"{float(gap.mean())}")
    assert float(gap.max()) <= 0.025 and float(gap.mean()) <= 0.005


def test_swinir_served_forward_takes_aligned_kernels_only(dev):
    """A served forward of 16 slices of 256^2 at the published widths:
    among its device kernels no sm80 ``align2`` GEMM (cuBLAS's choice for
    180-wide rows), no PyTorch LayerNorm, no cuDNN channel padding and no
    GELU pass; the padded LayerNorm, W and the fused MLP half are there."""
    from torch.profiler import ProfilerActivity, profile
    cfg = ModelConfig(model_type="swinir", base_filters=180, num_blocks=6)
    model = build_model(cfg, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)
                        ).to(dev).eval()
    x = torch.rand(16, 256, 256, 1,
                   generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            model(x)
            torch.cuda.synchronize()
    names = {e.key for e in p.key_averages()
             if e.device_type.name == "CUDA"}
    for bad in ("cutlass_80_tensorop_bf16_s16816gemm",
                "vectorized_layer_norm_kernel", "nhwcAddPaddingKernel",
                "GeluCUDA"):
        assert not [n for n in names if bad in n], (bad, names)
    assert [n for n in names if "padded_ln_kernel" in n]
    assert [n for n in names if "window_attention_kernel" in n]
    assert [n for n in names if "swin_mlp_kernel" in n]
