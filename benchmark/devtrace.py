"""The device trace of a run's traced window, read from ``torch.profiler``.

:class:`Tracer` turns the profiler on and off at fixed times inside the
measured window (the cell's loop calls :meth:`Tracer.tick`), so that the
trace covers a few seconds of steady work; it is read once the window has
closed. The traced window is the ``bench.window`` span recorded between
the two. The profiler slows the host while it runs and while it stops, so
the readers that take the host's clock leave that part of the window out
(:attr:`Tracer.traced`).

:class:`DeviceTrace` holds what the metric readers need: the device's
intervals (kernels, copies and memsets on every stream), the host's
outermost operations on every thread, and the benchmark's own
``bench.*`` spans. Busy time is the union of the device intervals inside
the window, so overlapping streams count once and copies count.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    i = name.find("(")
    return (name if i < 0 else name[:i]).strip()[:160]


def union(intervals: List[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The complement of the sorted disjoint ``busy`` in [lo, hi]."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _outermost(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """The spans of one thread that no other span of it contains."""
    out: List[Tuple[int, int, str]] = []
    for s, e, n in sorted(spans):
        if out and e <= out[-1][1]:
            continue
        out.append((s, e, n))
    return out


class _Cover:
    """Which span of a set of non-nested threads' spans covers a time."""

    def __init__(self, by_thread: Dict[int, List[Tuple[int, int, str]]]):
        self._lists = [(_outermost(v)) for v in by_thread.values() if v]
        self._starts = [[s for s, _, _ in lst] for lst in self._lists]

    def at(self, t: int) -> Optional[str]:
        best = None
        for lst, starts in zip(self._lists, self._starts):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and lst[i][1] > t:
                s, e, n = lst[i]
                if best is None or e - s > best[0]:
                    best = (e - s, n)
        return None if best is None else best[1]


@dataclass
class DeviceTrace:
    """One traced window; times in ns on the profiler's clock."""
    lo: int
    hi: int
    device: List[Tuple[int, int, str]] = field(default_factory=list)
    host_ops: Dict[int, List[Tuple[int, int, str]]] = field(
        default_factory=lambda: defaultdict(list))
    bench_spans: Dict[int, List[Tuple[int, int, str]]] = field(
        default_factory=lambda: defaultdict(list))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    def busy(self) -> List[Tuple[int, int]]:
        return union([(s, e) for s, e, _ in self.device], self.lo, self.hi)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def idle_share(self) -> Optional[float]:
        """The share of the window in which no device operation ran, or
        None where the trace holds no device operation at all."""
        if not self.device:
            return None
        return 1.0 - self.busy_s() / self.window_s

    def summed(self, pred) -> Tuple[int, float]:
        """(count, seconds) of the device operations inside the window
        whose name satisfies ``pred``."""
        n, t = 0, 0
        for s, e, name in self.device:
            if s >= self.lo and e <= self.hi and pred(name):
                n += 1
                t += e - s
        return n, t * 1e-9

    def copy_s(self) -> Tuple[int, float]:
        return self.summed(lambda n: _kind(n) == "copy")

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for s, e, name in self.device:
            s, e = max(s, self.lo), min(e, self.hi)
            if e > s:
                by[short_name(name)] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t * 1e-9] for n, t in top]

    def idle_by_host(self, k: int = 10) -> List[list]:
        """Idle device time summed by what the host was doing at each
        gap's middle: the benchmark's span there, and the outermost host
        operation of any thread; the ``k`` largest."""
        bench, ops = _Cover(self.bench_spans), _Cover(self.host_ops)
        by: Dict[str, int] = defaultdict(int)
        for s, e in gaps(self.busy(), self.lo, self.hi):
            mid = (s + e) // 2
            label = " / ".join(x for x in (bench.at(mid), ops.at(mid)) if x)
            by[label or "no torch op"] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t * 1e-9] for n, t in top]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_by_host()}


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")()) * 1000


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _activity(ev, annotations: set) -> str:
    """The kineto activity of ``ev`` (``kernel``, ``gpu_memcpy``,
    ``gpu_user_annotation``, ``cpu_op``, ``user_annotation``, ...). Where
    the event does not say (older PyTorch), a device event named as a
    host range is that range's image on the device."""
    fn = getattr(ev, "activity_type", None)
    if fn is not None:
        return str(fn())
    if str(ev.device_type()).endswith("CUDA"):
        if _annotated(ev) or ev.name() in annotations:
            return "gpu_user_annotation"
        return "kernel"
    return "user_annotation" if _annotated(ev) else "cpu_op"


def _annotated(ev) -> bool:
    fn = getattr(ev, "is_user_annotation", None)
    return bool(fn()) if fn is not None else ev.name().startswith("bench.")


def read_kineto(events) -> Optional[DeviceTrace]:
    """A :class:`DeviceTrace` from the profiler's kineto events, or None
    where the window's span is missing. The device's intervals are its
    kernels, copies and memsets; the device-side images of host ranges
    (``gpu_user_annotation``: the ``bench.*`` spans, ``Optimizer.step``)
    are not work and are left out."""
    events = list(events)
    annotations = {ev.name() for ev in events
                   if not str(ev.device_type()).endswith("CUDA")
                   and _annotated(ev)}
    window = None
    raw_device, host, bench = [], defaultdict(list), defaultdict(list)
    for ev in events:
        act = _activity(ev, annotations)
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if act in DEVICE_ACTIVITIES:
            raw_device.append((start, end, name))
        elif act == "user_annotation" and name == WINDOW_SPAN:
            window = (start, end)
        elif act == "user_annotation" and name.startswith("bench."):
            bench[ev.start_thread_id()].append((start, end, name))
        elif act == "cpu_op":
            host[ev.start_thread_id()].append((start, end, name))
    if window is None:
        return None
    tr = DeviceTrace(window[0], window[1])
    tr.device = [(s, e, n) for s, e, n in raw_device if e > s]
    tr.host_ops, tr.bench_spans = host, bench
    return tr


class Tracer:
    """Profiles ``seconds`` of the window from ``start_at`` on the host's
    ``time.perf_counter`` clock; inert where ``enabled`` is False."""

    def __init__(self, enabled: bool, start_at: float = 0.0,
                 seconds: float = 0.0):
        self.enabled = enabled
        self.start_at, self.seconds = start_at, seconds
        self.stop_at = start_at + seconds
        self._prof = None
        self._span = None
        self.trace: Optional[DeviceTrace] = None
        self.t_on: Optional[float] = None
        self.t_off: Optional[float] = None
        self.on = False
        self.done = not enabled

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once (CUPTI's first start takes
        about a second), so that the traced window starts at once."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts):
            torch.ones(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def tick(self, now: float) -> None:
        if self.done:
            return
        if not self.on and now >= self.start_at:
            self._start()
        elif self.on and now >= self.stop_at:
            self.stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self.t_on = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.on = True
        self.stop_at = time.perf_counter() + self.seconds

    def stop(self) -> None:
        """End the traced window (at the latest when the window ends). The
        trace is read later, by :meth:`read`, outside the window."""
        if not self.on:
            self.done = True
            return
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.t_off = time.perf_counter()
        self.on, self.done = False, True

    @property
    def traced(self) -> Optional[Tuple[float, float]]:
        """(from, to) on the host's clock: the part of the window that the
        profiler's start, its tracing and its stop took, or None."""
        return None if self.t_on is None else (self.t_on, self.t_off)

    def read(self) -> Optional[DeviceTrace]:
        """Reduce the stopped profiler's events to :attr:`trace`."""
        if self._prof is not None and not self.on:
            self.trace = read_kineto(
                self._prof.profiler.kineto_results.events())
            self._prof = None
        return self.trace

    def span(self, name: str):
        """A ``bench.<name>`` span of the host, for the trace's idle
        labels; nothing in an untraced run."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(f"bench.{name}")
