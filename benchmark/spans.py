"""The program's own spans over the traced window (``program_span``).

The port keeps a record of each of its spans while a profiler runs
(``mri_superresolution_torch/utils/spans.py``): name, start and end on the
profiler's clock, thread, and for some a device event pair. This module
takes those records from the port's recorder, found among the modules
this process has loaded (so the benchmark imports nothing of the port
here), and reduces them with the device trace of the same window. Every
function returns None where the run gives it nothing to read: the control
system or a program without spans, no spans in the window, or a window
whose records the recorder had to drop.
"""

from __future__ import annotations

import statistics
import sys
from typing import List, Optional, Tuple

from benchmark import devtrace

RECORDER = "mri_superresolution_torch.utils.spans"
LOCK = ("engine.page_lock", "engine.unlock")
# how far before the window a span still open in it may have begun
REACH_NS = 10 ** 9


def _recorder():
    return sys.modules.get(RECORDER)


def window_records(r) -> Optional[list]:
    """The records of the program's spans that overlap the traced window
    (``r["trace"]``), or None."""
    rec, tr = _recorder(), r.get("trace")
    if rec is None or tr is None or rec.overflowed(tr.lo):
        return None
    got = [s for s in rec.records(tr.lo - REACH_NS, tr.hi + REACH_NS)
           if s.end_ns > tr.lo and s.start_ns < tr.hi]
    return got or None


def _length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def _intersect(a: List[Tuple[int, int]], b: List[Tuple[int, int]]
               ) -> List[Tuple[int, int]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_split(r) -> Optional[dict]:
    """The window's device-idle ns split by what the program was doing,
    by exact coverage: ``lock`` under ``engine.page_lock`` or
    ``engine.unlock``, ``engine`` under any other ``engine.*`` span of any
    thread, ``caller`` the rest; and ``volumes``, the ``engine.page_lock``
    spans that begin in the window. None without a device operation in the
    trace, or without a volume."""
    recs, tr = window_records(r), r.get("trace")
    if recs is None or not tr.device:
        return None
    volumes = sum(1 for s in recs if s.name == "engine.page_lock"
                  and tr.lo <= s.start_ns < tr.hi)
    if volumes == 0:
        return None
    idle = devtrace.gaps(tr.busy(), tr.lo, tr.hi)
    lock = devtrace.union([(s.start_ns, s.end_ns) for s in recs
                           if s.name in LOCK], tr.lo, tr.hi)
    engine = devtrace.union([(s.start_ns, s.end_ns) for s in recs
                             if s.name.startswith("engine.")
                             and s.name not in LOCK], tr.lo, tr.hi)
    idle_lock = _intersect(idle, lock)
    lock_ns = _length(idle_lock)
    engine_ns = _length(_intersect(idle, engine)) \
        - _length(_intersect(idle_lock, engine))
    return {"volumes": volumes, "lock": lock_ns, "engine": engine_ns,
            "caller": _length(idle) - lock_ns - engine_ns}


def idle_ms_per_volume(r, part: str) -> Optional[float]:
    split = idle_split(r)
    return None if split is None else 1e-6 * split[part] / split["volumes"]


def _inside(r, name: str) -> list:
    """The window's records of ``name`` that lie within the window."""
    recs, tr = window_records(r), r["trace"]
    return [s for s in recs or [] if s.name == name
            and s.start_ns >= tr.lo and s.end_ns <= tr.hi]


def host_ms_median(r, name: str) -> Optional[float]:
    """The median host ms of one ``name`` span inside the window."""
    got = _inside(r, name)
    return 1e-6 * statistics.median(s.end_ns - s.start_ns for s in got) \
        if got else None


def device_ms_median(r, name: str) -> Optional[float]:
    """The median device ms of one ``name`` span inside the window, from
    its event pair."""
    rec = _recorder()
    got = [rec.device_ms(s) for s in _inside(r, name)] if rec else []
    got = [ms for ms in got if ms is not None]
    return statistics.median(got) if got else None


def phase_ms_per_step(r, phase: str) -> Optional[float]:
    """The device ms a training step of ``phase`` (``forward``, ``loss``,
    ``backward``, ``update``): the event pairs of that phase's spans within
    each ``train.step`` of the window, on its thread, summed; the median
    over the steps whose every such span was timed."""
    rec = _recorder()
    recs = window_records(r)
    if rec is None or recs is None:
        return None
    name = f"train.{phase}"
    per_step = []
    for step in _inside(r, "train.step"):
        ms = [rec.device_ms(s) for s in recs if s.name == name
              and s.thread == step.thread and s.start_ns >= step.start_ns
              and s.end_ns <= step.end_ns]
        if ms and None not in ms:
            per_step.append(sum(ms))
    return statistics.median(per_step) if per_step else None
