"""The padded-row LayerNorm (``kernels/padded_layer_norm.py``) on the CPU:
its plain version against ``F.layer_norm`` over the first C channels, the
pad written as zeros, the wrapper's refusals, and ``swin_ln_roofline``'s
reading of a made-up trace and made-up launch spans. The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py)."""

import importlib
import sys
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from benchmark import core, counts, devtrace, spans
from mri_superresolution_torch import kernels

# the module (the package's ``kernels.padded_layer_norm`` is the function)
pln = importlib.import_module("mri_superresolution_torch.kernels."
                              "padded_layer_norm")

torch.set_num_threads(2)


def _case(c, cp, lead, dtype=torch.float32, seed=0):
    """Rows (lead..., cp) whose first c channels are N(0.3, 2) and whose
    pad holds nonzero values that must not reach the sums; gamma, beta."""
    g = torch.Generator().manual_seed(seed)
    x = 0.3 + 2 * torch.randn(*lead, cp, generator=g)
    x[..., c:] = 7.0
    w = 1 + 0.1 * torch.randn(c, generator=g)
    b = 0.1 * torch.randn(c, generator=g)
    return x.to(dtype), w, b


@pytest.mark.parametrize("c, cp", [(180, 184), (60, 64), (96, 96)])
@pytest.mark.parametrize("lead", [(3, 7, 5), (13,)])        # ragged rows
def test_plain_is_layer_norm_over_the_first_c(c, cp, lead):
    x, w, b = _case(c, cp, lead)
    got = pln.padded_layer_norm_plain(x, w, b, 1e-5)
    want = F.layer_norm(x[..., :c], (c,), w, b, 1e-5)
    assert got.shape == x.shape and got.dtype == torch.float32
    torch.testing.assert_close(got[..., :c], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[..., c:], torch.zeros_like(got[..., c:]))
    # the wrapper on a CPU tensor is the plain version, counted as no launch
    kernels.reset_launch_counts()
    assert torch.equal(pln.padded_layer_norm(x, w, b, 1e-5), got)
    assert kernels.launch_counts()["padded_layer_norm"] == 0


def test_plain_in_bf16_rounds_the_fp32_result_once():
    x, w, b = _case(180, 184, (4, 9), torch.bfloat16, seed=1)
    got = pln.padded_layer_norm_plain(x, w, b, 1e-5)
    want = F.layer_norm(x[..., :180].float(), (180,), w, b, 1e-5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[..., :180], want.to(torch.bfloat16))
    assert not got[..., 180:].any()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w, b = _case(180, 184, (2, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        pln.padded_layer_norm(x[..., :180].contiguous(), w, b, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        pln.padded_layer_norm(x, torch.ones(190), torch.zeros(190), 1e-5)
    wide = torch.zeros(2, 8, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):      # row stride 192
        pln.padded_layer_norm(wide[..., :184], w, b, 1e-5)
    with pytest.raises(ValueError, match="float32"):
        pln.padded_layer_norm(x, w.bfloat16(), b, 1e-5)
    with pytest.raises(RuntimeError, match="no backward"):
        pln.padded_layer_norm(x.float().requires_grad_(), w, b, 1e-5)
    # the launch's own checks, before anything reaches the library: a
    # non-bf16 tensor, rows wider than the kernel's, a misaligned start
    with pytest.raises(ValueError, match="bfloat16"):
        pln._launch(x.float(), w, b, 1e-5)
    with pytest.raises(ValueError, match="wider than 512"):
        pln._launch(torch.zeros(2, 520, dtype=torch.bfloat16), w, b, 1e-5)
    flat = torch.zeros(1 + 2 * 184, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pln._launch(flat[1:].view(2, 184), w, b, 1e-5)


# ------------------------------------------------- swin_ln_roofline

NAME = "void (anonymous namespace)::padded_ln_kernel<3>(__nv_bfloat16 " \
       "const*, float const*, float const*, __nv_bfloat16*, long long, " \
       "int, int, float)"


def _rec(name, start, end, count=0):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, thread=1,
                           ms=None, count=count)


def _program(monkeypatch, records):
    monkeypatch.setitem(sys.modules, spans.RECORDER, SimpleNamespace(
        records=lambda lo, hi: [r for r in records
                                if r.start_ns >= lo and r.end_ns <= hi],
        overflowed=lambda lo: False, device_ms=lambda r: r.ms))


def test_swin_ln_roofline_reads_the_launches_rows_against_the_bound(
        monkeypatch):
    """Four launches of 1 ms in the trace among other kernels; five launch
    spans in the window (64 and 32 slices of 256^2 rows), the fifth not
    run by the window's end: the first four spans' rows of 2 x 180 x 2 B,
    over their 4 ms."""
    read = core.reader("swin_ln_roofline")
    assert read.__globals__["bytes_per_row"](180) == 720
    cfg, _ = core.config(core.manifest(), "swinir-classical-x2")
    tr = devtrace.DeviceTrace(0, 10 ** 9)
    tr.device = [(10 ** 8 + i * 2_000_000, 10 ** 8 + i * 2_000_000 + 10 ** 6,
                  NAME) for i in range(4)]
    tr.device += [(5, 6, "at::native::vectorized_layer_norm_kernel")]
    r = {"trace": tr, "config": cfg, "b1_site_hw": (256, 256)}
    hw = 256 * 256
    made = [_rec("kernel.swin_layer_norm", 1000 + 10 * i, 1005 + 10 * i,
                 count=n * hw) for i, n in enumerate((64, 64, 32, 32, 64))]
    _program(monkeypatch, made[::-1] + [_rec("swin.mlp", 990, 1100)])
    want = 100.0 * 192 * hw * 720 / counts.PEAK_HBM_BYTES_PER_S / 4e-3
    assert read(r) == pytest.approx(want)
    assert 0 < read(r) < 100
    # no launch of the kernel in the trace: a program without it
    assert read(dict(r, trace=devtrace.DeviceTrace(0, 10 ** 9))) is None
    _program(monkeypatch, made[:3])
    assert read(r) is None                  # fewer launch spans than launches
    monkeypatch.delitem(sys.modules, spans.RECORDER)
    assert read(r) is None                  # the control
