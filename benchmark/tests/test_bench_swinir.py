"""``swinir-volume-bf16`` at a size the CPU holds: the check passes the
program and refuses the fp8 control and each planted fault; the frozen
reference against the port; the FLOP count; the three readers of the
cell's own metrics on a made-up trace and made-up spans."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import core, counts, devtrace, faults, spans, systems, traffic
from benchmark import weights

MAN = core.manifest()
CELL = "swinir-volume-bf16"
CONFIG = "swinir-classical-x2"
# the published depth of a group and its widths but 24 channels (head size
# 4) and one group; volumes of 4 slices 32^2 in batches of 2, so that each
# fault touches half the slices and a 2 s window keeps about ten
SMALL_CFG = {"base_filters": 24, "num_blocks": 1}
SMALL_MIX = {"slices": 4, "height": 32, "width": 32, "pool": 2,
             "batch_size": 2, "sample": 100000}


def _run(system="program", trace=False, seed=2 ** 31 + 11):
    torch.manual_seed(0)
    return core.run(CELL, seed, 2.0, trace, "cpu", time.perf_counter(),
                    system=system, man=MAN, cfg_over=SMALL_CFG,
                    mix_over=SMALL_MIX)


def test_program_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"serve_slices_per_s", "setup_s"}


def test_control_is_refused():
    r = _run("control")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS["volume"])
def test_fault_is_refused(fault):
    with faults.planted(fault, "volume"):
        r = _run()
    assert not r["correct"], r["checks"]


def test_traced_run_reads_the_host_metrics():
    r = _run(trace=True)
    assert r["correct"]
    # on the CPU the device's and the spans' event pairs read nothing
    assert "serve_mfu" in r["metrics"]
    assert not {"wattn_roofline", "swin_attn_ms.serve",
                "swin_mlp_ms.serve"} & set(r["metrics"])


def test_reference_matches_port_fp32():
    from mri_superresolution_torch.models import build_model
    cfg, ref = core.config(MAN, CONFIG)
    cfg.update(SMALL_CFG)
    p = weights.make(ref.param_spec(cfg), 99, "cpu")
    model = build_model(systems._model_config(cfg))
    model.load_state_dict(p, strict=True)
    x = traffic.phantoms(5, 0, 3, 24, 40, "cpu")[..., None]
    with torch.no_grad():
        want = ref.forward(p, x)
        got = model(x)
    assert got.shape == want.shape == (3, 48, 80, 1)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_flops_a_slice_at_the_published_widths():
    cfg, ref = core.config(MAN, CONFIG)
    assert ref.flops_per_slice(cfg, 256, 256) == 1_632_750_796_800
    # 24,913,800 an input pixel
    assert ref.flops_per_slice(cfg, 8, 8) == 64 * 24_913_800
    params = sum(torch.Size(s).numel() for _, s, _, _ in
                 ref.param_spec(cfg))
    assert params == 11_748_093


KERNEL = ("(anonymous namespace)::window_attention_kernel(__nv_bfloat16 "
          "const*, float const*, __nv_bfloat16*, int, int, int, int, int, "
          "float)")


def test_wattn_roofline_reads_the_kernels_time_against_its_bound(monkeypatch):
    """Five launches of 2 ms in the trace among other kernels; six launch
    spans in the window, 64, 64, 32, 32, 32, 64 slices, the sixth not run
    by the window's end: the trace's launches took the first five spans'
    224 slices of 94.37 MB, bound by bytes, over their 10 ms."""
    read = core.reader("wattn_roofline")
    assert read.__globals__["bytes_per_slice"](256, 256, 180) == 94_371_840
    assert read.__globals__["flops_per_slice"](256, 256, 180) == \
        3_019_898_880
    cfg, _ = core.config(MAN, CONFIG)
    tr = devtrace.DeviceTrace(0, 10 ** 9)
    tr.device = [(10 ** 8 + i * 3_000_000, 10 ** 8 + i * 3_000_000 + 2_000_000,
                  KERNEL) for i in range(5)]
    tr.device += [(5, 6, "cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128")]
    r = {"trace": tr, "config": cfg, "b1_site_hw": (256, 256)}
    # made in this order, listed out of it; a block span beside them
    made = [_rec("kernel.window_attention", 1000 + 10 * i, 1005 + 10 * i,
                 count=n) for i, n in enumerate((64, 64, 32, 32, 32, 64))]
    _program(monkeypatch, made[::-1] + [_rec("swin.attn", 990, 1100)])
    want = 100.0 * 224 * 94_371_840 / counts.PEAK_HBM_BYTES_PER_S / 10e-3
    assert read(r) == pytest.approx(want)
    # no launch of the kernel in the trace: a program without it
    assert read(dict(r, trace=devtrace.DeviceTrace(0, 10 ** 9))) is None
    _program(monkeypatch, made[:4])
    assert read(r) is None                  # fewer launch spans than launches
    monkeypatch.delitem(sys.modules, spans.RECORDER)
    assert read(r) is None                  # the control


def _rec(name, start, end, ms=None, count=0, thread=1):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end,
                           thread=thread, ms=ms, count=count)


def _program(monkeypatch, records):
    monkeypatch.setitem(sys.modules, spans.RECORDER, SimpleNamespace(
        records=lambda lo, hi: [r for r in records
                                if r.start_ns >= lo and r.end_ns <= hi],
        overflowed=lambda lo: False, device_ms=lambda r: r.ms))


def _forward(t0, slices, attn_ms, mlp_ms, thread=1):
    recs = [_rec("engine.forward", t0, t0 + 90, ms=sum(attn_ms + mlp_ms),
                 count=slices, thread=thread)]
    for i, (a, m) in enumerate(zip(attn_ms, mlp_ms)):
        recs += [_rec("swin.attn", t0 + 1 + 4 * i, t0 + 3 + 4 * i, a,
                      thread=thread),
                 _rec("swin.mlp", t0 + 3 + 4 * i, t0 + 5 + 4 * i, m,
                      thread=thread)]
    return recs


def test_swin_spans_read_device_ms_a_slice(monkeypatch):
    """A forward of 64 slices and one of 32 inside the window (two blocks
    each), one that begins before it: (64 + 32) / 96 slices' worth."""
    recs = _forward(1100, 64, [10.0, 12.0], [6.0, 6.0]) + \
        _forward(1300, 32, [5.0, 5.0], [3.0, 3.0]) + \
        _forward(950, 64, [99.0, 99.0], [99.0, 99.0]) + \
        [_rec("swin.attn", 1302, 1303, 77.0, thread=2)]   # other thread
    _program(monkeypatch, recs)
    r = {"trace": devtrace.DeviceTrace(1000, 2000)}
    assert core.reader("swin_attn_ms.serve")(r) == pytest.approx(32 / 96)
    assert core.reader("swin_mlp_ms.serve")(r) == pytest.approx(18 / 96)


def test_swin_spans_read_nothing_without_something_to_read(monkeypatch):
    r = {"trace": devtrace.DeviceTrace(1000, 2000)}
    for name in ("swin_attn_ms.serve", "swin_mlp_ms.serve"):
        read = core.reader(name)
        monkeypatch.delitem(sys.modules, spans.RECORDER, raising=False)
        assert read(r) is None                      # the control
        _program(monkeypatch, [])
        assert read(r) is None                      # no spans
        recs = _forward(1100, 64, [1.0], [1.0])
        recs[1] = _rec("swin.attn", 1101, 1103, None)
        recs[2] = _rec("swin.mlp", 1103, 1105, None)
        _program(monkeypatch, recs)
        assert read(r) is None                      # a block untimed
        _program(monkeypatch, _forward(1100, 0, [1.0], [1.0]))
        assert read(r) is None                      # no slices counted
        _program(monkeypatch, [_rec("engine.forward", 1100, 1190, ms=3.0,
                                    count=64)])
        assert read(r) == 0.0                       # a forward of no block
