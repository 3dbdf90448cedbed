"""SwinIR's fused MLP half (``kernels/swin_mlp.py``) on the CPU: its plain
version against the unfused served sequence it replaces (the padded
LayerNorm, fc1, GELU, fc2 and the add), the pad written as zeros, the
kernel's zero-padded weight layout changing nothing, the widths the kernel
takes, the wrapper's refusals, the SwinIR route, and
``swin_mlp_roofline``'s reading of a made-up trace. The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py)."""

import importlib
import sys
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import core, counts, devtrace, spans
from mri_superresolution_torch import kernels
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import swinir as sw

# the module (the package's ``kernels.swin_mlp`` is the function)
mlp = importlib.import_module("mri_superresolution_torch.kernels.swin_mlp")

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative


def _block(c, hidden, seed=0):
    """A Swin block's norm2, fc1 and fc2 at C = c, with weights of the
    served model's scale (LN scale 1 + N(0, 0.1), fc1 N(0, 1/c), fc2 at
    half the variance-keeping std, biases N(0, 0.1))."""
    g = torch.Generator().manual_seed(seed)
    norm, fc1, fc2 = nn.LayerNorm(c, eps=1e-5), nn.Linear(c, hidden), \
        nn.Linear(hidden, c)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        norm.bias.copy_(0.1 * torch.randn(c, generator=g))
        fc1.weight.copy_(torch.randn(hidden, c, generator=g) / c ** 0.5)
        fc1.bias.copy_(0.1 * torch.randn(hidden, generator=g))
        fc2.weight.copy_(0.5 * torch.randn(c, hidden, generator=g) /
                         hidden ** 0.5)
        fc2.bias.copy_(0.1 * torch.randn(c, generator=g))
    return norm, fc1, fc2


def _rows(lead, c, cp, dtype, seed=1):
    """Rows (lead..., cp) whose first c channels are N(0.3, 1) and whose
    pad is zero, as the served stream keeps it."""
    g = torch.Generator().manual_seed(seed)
    x = 0.3 + torch.randn(*lead, cp, generator=g)
    x[..., c:] = 0
    return x.to(dtype)


def _unfused(x, norm, fc1, fc2):
    """The served sequence the kernel replaces, as ``SwinBlock.forward``
    ran it on rows of Cp."""
    h = F.gelu(sw._linear(sw._ln(x, norm, True), fc1, True))
    return x + sw._linear(h, fc2, True)


WIDTHS = [(180, 184, 360), (60, 64, 120)]    # classical; lightweight


@pytest.mark.parametrize("c, cp, hidden", WIDTHS)
def test_plain_matches_the_unfused_sequence_in_fp32(c, cp, hidden):
    norm, fc1, fc2 = _block(c, hidden)
    x = _rows((3, 5, 7), c, cp, torch.float32)
    with torch.no_grad():
        got = mlp.swin_mlp_plain(x, norm, fc1, fc2, c)
        want = _unfused(x, norm, fc1, fc2)
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[..., c:], torch.zeros_like(got[..., c:]))


@pytest.mark.parametrize("c, cp, hidden", WIDTHS)
def test_plain_matches_the_unfused_sequence_in_bf16(c, cp, hidden):
    """The unfused sequence rounds fc1's output, the biases and fc2's
    output to bf16 besides; the plain version rounds the LN output, the
    hidden and the output once each. They agree within 2 bf16 ulps of the
    largest output, and the plain version is the closer of the two to the
    same sequence in fp32."""
    norm, fc1, fc2 = _block(c, hidden, seed=2)
    x = _rows((4, 9, 11), c, cp, torch.bfloat16, seed=3)
    with torch.no_grad():
        got = mlp.swin_mlp_plain(x, norm, fc1, fc2, c)
        want = _unfused(x, norm, fc1, fc2)
        exact = mlp.swin_mlp_plain(x.float(), norm, fc1, fc2, c)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    top = float(exact.abs().max())
    assert float((got.float() - want.float()).abs().max()) <= \
        2 * BF16_ULP * top
    assert float((got.float() - exact).abs().mean()) < \
        float((want.float() - exact).abs().mean())
    assert not got[..., c:].any()


def test_pad_of_the_input_reaches_nothing():
    """Whatever the input's pad holds, the first C output channels are
    those of a zero pad and the output's pad is zero."""
    norm, fc1, fc2 = _block(180, 360, seed=4)
    x = _rows((2, 33), 180, 184, torch.bfloat16, seed=5)
    dirty = x.clone()
    dirty[..., 180:] = 7.0
    with torch.no_grad():
        got = mlp.swin_mlp_plain(dirty, norm, fc1, fc2, 180)
        want = mlp.swin_mlp_plain(x, norm, fc1, fc2, 180)
    assert torch.equal(got, want)
    assert not got[..., 180:].any()


def _unpacked(packed, cp, chunks):
    """W1 (chunks * 64, K) and W2 (cp, chunks * 64) read back from the
    kernel's layout by its documented formula: in each chunk's row, W1's
    K-blocks of 64 channels, 64 rows of 128 bytes each, then W2's cp rows
    of 128 bytes; in each row the 8-channel group g lies at g ^ (row % 8)."""
    kp = -(-cp // 16) * 16
    w1 = torch.zeros(chunks * 64, kp, dtype=packed.dtype)
    w2 = torch.zeros(cp, chunks * 64, dtype=packed.dtype)
    for j in range(chunks):
        a = packed[j, :64 * kp].view(kp // 64, 64, 8, 8)
        b = packed[j, 64 * kp:].view(cp, 8, 8)
        for r in range(64):
            for g in range(8):
                for kb in range(kp // 64):
                    w1[j * 64 + r, kb * 64 + g * 8:kb * 64 + g * 8 + 8] = \
                        a[kb, r, g ^ (r % 8)]
        for r in range(cp):
            for g in range(8):
                w2[r, j * 64 + g * 8:j * 64 + g * 8 + 8] = b[r, g ^ (r % 8)]
    return w1, w2


@pytest.mark.parametrize("c, cp, hidden", WIDTHS + [(180, 184, 100)])
def test_zero_padded_weights_change_nothing(c, cp, hidden):
    """The kernel's weights read back from its layout are fc1's and fc2's
    in bf16, zero-padded to K = cp rounded up to 16 and to a hidden of a
    multiple of 64; the padded product (the normalized rows zero past C)
    equals the unpadded one in float64."""
    norm, fc1, fc2 = _block(c, hidden, seed=6)
    chunks = -(-hidden // 64)
    kp = -(-cp // 16) * 16
    packed = mlp.packed_weights(fc1.weight, fc2.weight, cp)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (chunks, 64 * kp + cp * 64)
    w1, w2 = _unpacked(packed, cp, chunks)
    assert torch.equal(w1[:hidden, :c], fc1.weight.detach().bfloat16())
    assert torch.equal(w2[:c, :hidden], fc2.weight.detach().bfloat16())
    assert not w1[hidden:].any() and not w1[:, c:].any()
    assert not w2[c:].any() and not w2[:, hidden:].any()
    g = torch.Generator().manual_seed(7)
    n = torch.randn(13, c, generator=g, dtype=torch.float64)
    np_ = F.pad(n, (0, kp - c))
    b1 = F.pad(fc1.bias.detach().double(), (0, chunks * 64 - hidden))
    h = F.gelu(np_ @ w1.double().t() + b1)
    got = h @ w2.double().t()
    want = F.gelu(n @ fc1.weight.detach().bfloat16().double().t() +
                  fc1.bias.detach().double()) @ \
        fc2.weight.detach().bfloat16().double().t()
    torch.testing.assert_close(got[:, :c], want, rtol=1e-12, atol=1e-12)
    assert not got[:, c:].any()


def test_the_widths_the_kernel_takes():
    assert mlp.serves(184, 360, torch.bfloat16)          # classical
    assert mlp.serves(184, 100, torch.bfloat16)          # 2 chunks
    assert not mlp.serves(64, 120, torch.bfloat16)       # no instance
    assert not mlp.serves(96, 192, torch.bfloat16)       # no instance
    assert not mlp.serves(184, 360, torch.float32)
    assert not mlp.serves(184, 720, torch.bfloat16)      # hidden too wide


def test_wrapper_refuses_what_the_kernel_does_not_take():
    norm, fc1, fc2 = _block(180, 360)
    x = _rows((2, 8), 180, 184, torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiple of 8"):
            mlp.swin_mlp(x[..., :180].contiguous(), norm, fc1, fc2, 180)
        with pytest.raises(ValueError, match="bfloat16"):
            mlp.swin_mlp(x.float(), norm, fc1, fc2, 180)
        wide = torch.zeros(2, 8, 192, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="contiguous"):
            mlp.swin_mlp(wide[..., :184], norm, fc1, fc2, 180)
        flat = torch.zeros(1 + 2 * 184, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte aligned"):
            mlp.swin_mlp(flat[1:].view(2, 184), norm, fc1, fc2, 180)
        with pytest.raises(ValueError, match="one hidden"):
            mlp.swin_mlp(x, norm, fc1, nn.Linear(360, 176), 180)
    with pytest.raises(RuntimeError, match="no backward"):
        mlp.swin_mlp(x, norm, fc1, fc2, 180)            # params need grad
    # the launch's own check, before anything reaches the library: a
    # width the kernel has no instance for
    n96, f96, g96 = _block(90, 180)
    with torch.no_grad(), pytest.raises(ValueError, match="rows of"):
        mlp._launch(_rows((2,), 90, 96, torch.bfloat16), n96, f96, g96, 90)


def test_wrapper_on_a_cpu_tensor_is_the_plain_version():
    norm, fc1, fc2 = _block(60, 120, seed=8)
    x = _rows((3, 7), 60, 64, torch.bfloat16, seed=9)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = mlp.swin_mlp(x, norm, fc1, fc2, 60)
        want = mlp.swin_mlp_plain(x, norm, fc1, fc2, 60)
    assert torch.equal(got, want)
    assert kernels.launch_counts()["swin_mlp"] == 0


SMALL = ModelConfig(model_type="swinir", base_filters=180, num_blocks=1,
                    swin_depth=2, swin_heads=6, window_size=8, num_feat=16)


def _count_calls(monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return mlp.swin_mlp(*args)

    monkeypatch.setattr(sw, "swin_mlp", counted)
    return calls


def test_swinir_on_the_cpu_takes_the_unfused_ops_bit_for_bit(monkeypatch):
    """A bf16 SwinIR at a width the kernel takes (C = 180, rows of 184),
    on a CPU tensor: not the served path, so no block calls the kernel's
    wrapper and each block's MLP half is the unfused ops, bit for bit."""
    m = build_model(SMALL, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(10))
    calls = _count_calls(monkeypatch)
    x = torch.rand(2, 16, 16, 1, generator=torch.Generator().manual_seed(11))
    blk = m.layers[0].residual_group.blocks[1]
    t = torch.randn(2, 16, 16, 180, generator=torch.Generator().manual_seed(
        12)).bfloat16()
    with torch.no_grad():
        assert not m.served(x)
        m(x)
        got = blk(t, False)
        a = blk.attn
        y = sw.window_attention(sw._linear(sw._ln(t, blk.norm1, False),
                                           a.qkv, False),
                                a.relative_position_bias_table, a.heads,
                                a.window, blk.shift, 180, 180)
        y = t + sw._linear(y, a.proj, False)
        want = y + sw._linear(F.gelu(sw._linear(
            sw._ln(y, blk.norm2, False), blk.mlp.fc1, False)), blk.mlp.fc2,
            False)
    assert calls == []
    assert torch.equal(got, want)


@pytest.mark.parametrize("c, want", [(180, 2), (60, 0)])
def test_served_route_takes_the_kernel_where_it_serves(monkeypatch, c, want):
    """The served path's arithmetic forced on the CPU in bf16: every block
    hands its MLP half to the wrapper where the kernel takes the rows (184
    wide), none where it does not (64 wide)."""
    cfg = ModelConfig(model_type="swinir", base_filters=c, num_blocks=1,
                      swin_depth=2, swin_heads=6, window_size=8, num_feat=16)
    m = build_model(cfg, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(13))
    calls = _count_calls(monkeypatch)
    x = torch.rand(1, 16, 16, 1, generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        m._forward(x, True)
    assert len(calls) == want
    assert all(s[-1] == 184 for s in calls)


# ------------------------------------------------- swin_mlp_roofline

NAME = "void (anonymous namespace)::swin_mlp_kernel<184>(__nv_bfloat16 " \
       "const*, __nv_bfloat16 const*, float const*, float const*, float " \
       "const*, float const*, __nv_bfloat16*, long long, int, int, int, " \
       "float)"


def _rec(name, start, end, count=0):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, thread=1,
                           ms=None, count=count)


def _program(monkeypatch, records):
    monkeypatch.setitem(sys.modules, spans.RECORDER, SimpleNamespace(
        records=lambda lo, hi: [r for r in records
                                if r.start_ns >= lo and r.end_ns <= hi],
        overflowed=lambda lo: False, device_ms=lambda r: r.ms))


def test_swin_mlp_roofline_reads_the_launches_rows_against_the_bound(
        monkeypatch):
    """Four launches of 2 ms in the trace among other kernels; five launch
    spans in the window (64 and 32 slices of 256^2 rows), the fifth not
    run by the window's end: the first four spans' rows at the larger of
    4 x 180 x 360 operations over the bf16 peak and 2 x 180 x 2 B over the
    bandwidth (operations bind), over their 8 ms."""
    read = core.reader("swin_mlp_roofline")
    assert read.__globals__["flops_per_row"](180, 360) == 259_200
    assert read.__globals__["bytes_per_row"](180) == 720
    cfg, _ = core.config(core.manifest(), "swinir-classical-x2")
    tr = devtrace.DeviceTrace(0, 10 ** 9)
    tr.device = [(10 ** 8 + i * 3_000_000, 10 ** 8 + i * 3_000_000 +
                  2_000_000, NAME) for i in range(4)]
    tr.device += [(5, 6, "padded_ln_kernel")]
    r = {"trace": tr, "config": cfg, "b1_site_hw": (256, 256)}
    hw = 256 * 256
    made = [_rec("kernel.swin_mlp", 1000 + 10 * i, 1005 + 10 * i,
                 count=n * hw) for i, n in enumerate((64, 64, 32, 32, 64))]
    _program(monkeypatch, made[::-1] + [_rec("swin.mlp", 990, 1100)])
    rows = 192 * hw
    want = 100.0 * max(rows * 259_200 / counts.PEAK_BF16_FLOPS,
                       rows * 720 / counts.PEAK_HBM_BYTES_PER_S) / 8e-3
    assert read(r) == pytest.approx(want)
    assert 0 < read(r) < 100
    # no launch of the kernel in the trace: a program without it
    assert read(dict(r, trace=devtrace.DeviceTrace(0, 10 ** 9))) is None
    _program(monkeypatch, made[:3])
    assert read(r) is None                  # fewer launch spans than launches
    monkeypatch.delitem(sys.modules, spans.RECORDER)
    assert read(r) is None                  # the control
