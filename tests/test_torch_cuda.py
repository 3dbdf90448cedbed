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
    group_norm_leaky, group_norm_leaky_plain)
from mri_superresolution_torch.kernels.ssim import (ssim_per_sample,
                                                    ssim_per_sample_plain)
from mri_superresolution_torch.models import build_model

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


@pytest.mark.parametrize("shape,window", [((3, 27, 35), 11),
                                          ((2, 512, 512), 11),
                                          ((1, 40, 33), 7)])
def test_ssim_kernel(dev, shape, window):
    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.rand(shape, generator=gen, device=dev)
    b = (a + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    got = ssim_per_sample(a, b, window_size=window)
    torch.testing.assert_close(
        got, ssim_per_sample_plain(a, b, window_size=window), rtol=0,
        atol=1e-5)
    # fixed-order reductions: the same bits on every run
    assert torch.equal(got, ssim_per_sample(a, b, window_size=window))


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
    assert kernels.launch_counts() == {"group_norm_leaky": 20, "conv3x3": 2,
                                       "ssim_per_sample": 0}
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
