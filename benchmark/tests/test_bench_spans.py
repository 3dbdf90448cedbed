"""The readers of the program's spans (``benchmark/spans.py``): the idle
time split by exact coverage, the medians, nothing read where there is
nothing to read, the device trace's own readings unmoved by the program's
ranges, and on the card a number for every metric they read."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import core, devtrace, spans
from benchmark.tests.small import run
from benchmark.tests.test_bench_measure import _Ev

MAN = core.manifest()
SPAN_METRICS = {m["name"]: m for m in MAN["per_layer"]
                if m["source"] == "program_span"}


class _Rec(SimpleNamespace):
    pass


def _rec(name, start, end, thread=1, ms=None):
    return _Rec(name=name, start_ns=start, end_ns=end, thread=thread, ms=ms)


def _recorder(records, dropped_end=-1):
    return SimpleNamespace(
        records=lambda lo, hi: [r for r in records
                                if r.start_ns >= lo and r.end_ns <= hi],
        overflowed=lambda lo: dropped_end >= lo,
        device_ms=lambda r: r.ms)


@pytest.fixture
def program(monkeypatch):
    """Puts a recorder holding the given records where the port's is."""
    def put(records, dropped_end=-1):
        monkeypatch.setitem(sys.modules, spans.RECORDER,
                            _recorder(records, dropped_end))
    return put


def _trace():
    # window [1000, 2000]; the device busy over [1000, 1100], [1300, 1400],
    # [1800, 1900]: idle [1100, 1300], [1400, 1800], [1900, 2000] = 700
    tr = devtrace.DeviceTrace(1000, 2000)
    tr.device = [(1000, 1100, "k"), (1300, 1400, "k"), (1800, 1900, "k")]
    return {"trace": tr}


# two volumes: each page-locked, two dispatches, collected, unlocked; the
# second thread's collect overlaps the first unlock
VOLUMES = [
    _rec("engine.page_lock", 900, 1050),     # begins before the window
    _rec("engine.dispatch", 1050, 1150),
    _rec("engine.upload", 1060, 1080),
    _rec("engine.forward", 1080, 1140, ms=0.5),
    _rec("engine.collect", 1150, 1250),
    _rec("engine.unlock", 1250, 1350),
    _rec("engine.collect", 1300, 1330, thread=2),
    _rec("engine.page_lock", 1500, 1550),
    _rec("engine.dispatch", 1550, 1650),
    _rec("engine.forward", 1560, 1640, ms=0.7),
    _rec("engine.dispatch", 1650, 1700),
    _rec("engine.forward", 1660, 1690, ms=0.9),
    _rec("engine.page_lock", 1950, 2050),    # begins in the window
]


def test_idle_is_split_exactly_by_coverage(program):
    program(VOLUMES)
    r = _trace()
    split = spans.idle_split(r)
    # idle [1100, 1300]: engine 1100-1250 (dispatch, collect), lock
    # 1250-1300; [1400, 1800]: caller 1400-1500, lock 1500-1550, engine
    # 1550-1700, caller 1700-1800; [1900, 2000]: caller 1900-1950, lock
    # 1950-2000
    assert split == {"volumes": 2, "lock": 50 + 50 + 50,
                     "engine": 150 + 150, "caller": 100 + 100 + 50}
    assert split["lock"] + split["engine"] + split["caller"] == 700
    per = {p: spans.idle_ms_per_volume(r, p)
           for p in ("caller", "lock", "engine")}
    assert per == pytest.approx({"caller": 125e-6, "lock": 75e-6,
                                 "engine": 150e-6})
    idle_ns = r["trace"].window_s * 1e9 - r["trace"].busy_s() * 1e9
    assert sum(per.values()) * split["volumes"] * 1e6 == \
        pytest.approx(idle_ns)


def test_idle_readers_by_name(program):
    program(VOLUMES)
    r = _trace()
    got = {n: core.reader(n)(r) for n in ("idle_caller_ms.serve",
                                          "idle_lock_ms.serve",
                                          "idle_engine_ms.serve")}
    assert got == pytest.approx({"idle_caller_ms.serve": 125e-6,
                                 "idle_lock_ms.serve": 75e-6,
                                 "idle_engine_ms.serve": 150e-6})


def test_medians_of_the_engine_spans(program):
    program(VOLUMES)
    r = _trace()
    # dispatches inside the window: 100, 100, 50 ns
    assert core.reader("dispatch_ms.serve")(r) == pytest.approx(100e-6)
    assert core.reader("forward_ms.serve")(r) == pytest.approx(0.7)


def test_phases_summed_within_each_step(program):
    steps = []
    for i, (fwd, bwd) in enumerate(((1.0, 3.0), (2.0, 5.0), (3.0, 4.0))):
        t = 1000 + 300 * i
        steps += [_rec("train.step", t, t + 250),
                  # two microbatches
                  _rec("train.forward", t + 10, t + 40, ms=fwd / 2),
                  _rec("train.loss", t + 40, t + 50, ms=0.25),
                  _rec("train.backward", t + 50, t + 90, ms=bwd / 2),
                  _rec("train.forward", t + 90, t + 120, ms=fwd / 2),
                  _rec("train.loss", t + 120, t + 130, ms=0.25),
                  _rec("train.backward", t + 130, t + 170, ms=bwd / 2),
                  _rec("train.update", t + 170, t + 240, ms=0.75)]
    # a forward of another thread inside the first step is not its own
    steps.append(_rec("train.forward", 1015, 1030, thread=2, ms=50.0))
    program(steps)
    r = {"trace": devtrace.DeviceTrace(1000, 2000)}
    got = {p: core.reader(f"{p}_ms.train")(r)
           for p in ("forward", "loss", "backward", "update")}
    assert got == {"forward": 2.0, "loss": 0.5, "backward": 4.0,
                   "update": 0.75}


def test_untimed_step_is_left_out(program):
    program([_rec("train.step", 1000, 1200),
             _rec("train.forward", 1010, 1100, ms=None),
             _rec("train.step", 1300, 1500),
             _rec("train.forward", 1310, 1400, ms=4.0)])
    r = {"trace": devtrace.DeviceTrace(1000, 2000)}
    assert spans.phase_ms_per_step(r, "forward") == 4.0


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_nothing_to_read_reads_none(program, monkeypatch, name):
    read = core.reader(name)
    r = _trace()
    monkeypatch.delitem(sys.modules, spans.RECORDER, raising=False)
    assert read(r) is None                       # no recorder: the control
    program([])
    assert read(r) is None                       # no spans
    program([_rec("engine.dispatch", 10, 20)])
    assert read(r) is None                       # none in the window
    everything = VOLUMES + [_rec("train.step", 1000, 1200)] + [
        _rec(f"train.{p}", 1010 + 10 * i, 1015 + 10 * i, ms=1.0)
        for i, p in enumerate(("forward", "loss", "backward", "update"))]
    program(everything)
    assert read(r) is not None
    program(everything, dropped_end=1000)
    assert read(r) is None                       # the store overflowed


def _kineto(extra):
    """A window's events as an older PyTorch gives them (no activity
    type), with ``extra`` added."""
    return [_Ev(devtrace.WINDOW_SPAN, 0, 1000, False, True),
            _Ev("bench.volume", 0, 900, False, True),
            _Ev("bench.volume", 5, 880, True),
            _Ev("aten::copy_", 100, 50, False),
            _Ev("aten::conv2d", 200, 300, False),
            _Ev("gn_onepass_kernel", 150, 200, True),
            _Ev("Memcpy HtoD (Pinned -> Device)", 400, 20, True),
            _Ev("cudaHostRegister", 600, 100, False, tid=2)] + extra


PROGRAM_RANGES = [
    _Ev("engine.dispatch", 90, 500, False, True),
    _Ev("engine.upload", 95, 60, False, True),
    _Ev("engine.forward", 190, 320, False, True),
    _Ev("engine.forward", 195, 400, True),          # its image on the card
    _Ev("engine.page_lock", 590, 120, False, True, tid=2),
    _Ev("train.step", 0, 900, False, True, tid=3),
]


def test_the_programs_ranges_move_no_reading_of_the_trace():
    a = devtrace.read_kineto(_kineto([]))
    b = devtrace.read_kineto(_kineto(PROGRAM_RANGES))
    assert (a.lo, a.hi) == (b.lo, b.hi)
    assert a.device == b.device
    assert dict(a.host_ops) == dict(b.host_ops)
    assert dict(a.bench_spans) == dict(b.bench_spans)
    assert a.idle_by_host() == b.idle_by_host()
    assert a.breakdown() == b.breakdown()
    assert a.idle_share() == b.idle_share()


def test_a_real_trace_reads_the_same_without_the_programs_ranges():
    """A CPU profile with the port's spans in it, read whole and with
    those ranges taken out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from mri_superresolution_torch.utils.spans import span
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function(devtrace.WINDOW_SPAN):
            with span("engine.dispatch"):
                with span("engine.forward"):
                    torch.ones(32, 32) @ torch.ones(32, 32)
    events = list(p.profiler.kineto_results.events())
    ours = [e for e in events if e.name().startswith("engine.")]
    assert len(ours) == 2
    a = devtrace.read_kineto(events)
    b = devtrace.read_kineto([e for e in events if e not in ours])
    assert a.device == b.device
    assert dict(a.host_ops) == dict(b.host_ops)
    assert a.breakdown() == b.breakdown()


def test_a_traced_cpu_run_reads_the_dispatch():
    """The small volume cell, traced on the CPU: the host's span median
    reads; the device's (idle, events) have nothing to read there."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)     # beside other test processes
    try:
        r = run("unet-volume-bf16", seconds=3.0, trace=True)
    finally:
        torch.set_num_threads(threads)
    assert r["correct"]
    assert "dispatch_ms.serve" in r["metrics"], (r["metrics"], r["notes"])
    assert r["metrics"]["dispatch_ms.serve"]["value"] > 0
    for name in ("idle_caller_ms.serve", "idle_lock_ms.serve",
                 "idle_engine_ms.serve", "forward_ms.serve"):
        assert name not in r["metrics"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_traced_cell_reads_every_span_metric(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 33 + 11), "--seconds", "6", "--trace", "1"],
        cwd=str(core.ROOT), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    want = {n for n, m in SPAN_METRICS.items() if workload in m["workloads"]}
    assert want and want <= set(res["metrics"]), sorted(res["metrics"])
    if "idle_caller_ms.serve" in want:
        idle_s = res["device"]["window_s"] - res["device"]["busy_s"]
        per_volume = sum(res["metrics"][f"idle_{p}_ms.serve"]["value"]
                         for p in ("caller", "lock", "engine"))
        assert per_volume > 0 and idle_s > 0
