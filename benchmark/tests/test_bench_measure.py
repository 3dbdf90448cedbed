"""Whole-window rates and the device trace's union of intervals."""

import pytest

from benchmark import counts, devtrace, measure, readers


def test_rate_is_the_whole_window():
    assert measure.rate(500, 2.0) == 250.0
    with pytest.raises(ValueError):
        measure.rate(1, 0.0)


def test_union_counts_overlap_once():
    busy = devtrace.union([(0, 10), (5, 15), (20, 30), (-5, 2), (40, 60)],
                          0, 50)
    assert busy == [(0, 15), (20, 30), (40, 50)]
    assert devtrace.gaps(busy, 0, 50) == [(15, 20), (30, 40)]


def test_idle_share_over_streams_and_copies():
    tr = devtrace.DeviceTrace(0, 100)
    tr.device = [(0, 30, "kernel_a"), (10, 40, "kernel_b"),
                 (50, 60, "Memcpy HtoD (Pinned -> Device)"),
                 (90, 120, "kernel_a")]
    # busy: [0, 40] + [50, 60] + [90, 100] = 60 of 100
    assert tr.busy_s() == pytest.approx(60e-9)
    assert tr.idle_share() == pytest.approx(0.4)
    assert tr.copy_s() == (1, pytest.approx(10e-9))
    assert tr.summed(lambda n: n == "kernel_a") == (1, pytest.approx(30e-9))
    assert tr.top_ops()[0][0] == "kernel_a"


def test_idle_gaps_labelled_by_the_host():
    tr = devtrace.DeviceTrace(0, 100)
    tr.device = [(0, 40, "k"), (60, 100, "k")]
    tr.bench_spans[1] = [(30, 70, "bench.collect")]
    tr.host_ops[2] = [(45, 55, "aten::sort"), (46, 50, "aten::empty")]
    assert tr.idle_by_host() == [["bench.collect / aten::sort",
                                  pytest.approx(20e-9)]]


def test_no_device_operation_reads_nothing():
    assert devtrace.DeviceTrace(0, 100).idle_share() is None


def test_kineto_reading_finds_the_window():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function(devtrace.WINDOW_SPAN):
            with record_function("bench.step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    tr = devtrace.read_kineto(p.profiler.kineto_results.events())
    assert tr is not None and tr.window_s > 0
    assert any(n == "bench.step" for spans in tr.bench_spans.values()
               for _, _, n in spans)


class _Ev:
    """A kineto event as older PyTorch gives it: no ``activity_type``."""

    def __init__(self, name, start, dur, cuda, annotation=False, tid=1):
        self._n, self._s, self._d = name, start, dur
        self._cuda, self._a, self._t = cuda, annotation, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return self._t


def test_device_images_of_host_ranges_are_not_work():
    evs = [_Ev(devtrace.WINDOW_SPAN, 0, 100, False, True),
           _Ev("bench.volume", 0, 100, False, True),
           _Ev("bench.volume", 5, 90, True),       # its image on the card
           _Ev("Optimizer.step#Adam.step", 10, 10, False, True),
           _Ev("Optimizer.step#Adam.step", 12, 60, True),
           _Ev("gn_onepass_kernel", 20, 10, True),
           _Ev("Memcpy DtoH (Device -> Pinned)", 50, 10, True)]
    tr = devtrace.read_kineto(evs)
    assert sorted(n for _, _, n in tr.device) == [
        "Memcpy DtoH (Device -> Pinned)", "gn_onepass_kernel"]
    assert tr.idle_share() == pytest.approx(0.8)


def test_host_clock_readings_leave_the_traced_part_out():
    # 10 s window; the profiler ran (and stopped) over [2, 5]
    work = [(t, t + 1.0, 10) for t in range(10)]
    r = {"t0": 0.0, "t_end": 10.0, "traced": (2.0, 5.0), "work": work,
         "flops_per_slice": counts.PEAK_BF16_FLOPS / 1000.0}
    units, seconds = readers.untraced(r)
    assert [u[0] for u in units] == [0, 1, 5, 6, 7, 8, 9]
    assert seconds == 7.0
    # 70 slices of a thousandth of a peak second each in 7 s: 1% of peak
    assert readers.mfu_pct(r) == pytest.approx(1.0)
    assert readers.mfu_pct(dict(r, traced=None)) == pytest.approx(1.0)


def test_tracer_reads_after_it_stops():
    import time
    import torch
    tr = devtrace.Tracer(True, time.perf_counter(), 0.05)
    tr.tick(time.perf_counter())
    assert tr.on
    torch.ones(32, 32) @ torch.ones(32, 32)
    time.sleep(0.06)
    tr.tick(time.perf_counter())
    assert tr.done and tr.trace is None
    lo, hi = tr.traced
    assert hi - lo >= 0.05
    assert tr.read() is not None and tr.trace.window_s > 0
