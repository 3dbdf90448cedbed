"""The program's spans, on the profiler's clock.

``with span("engine.forward", device):`` marks a piece of the engine's or
the trainer's work. While a ``torch.profiler`` runs, the span is a
``record_function`` range (it shows in the profiler's trace and in
``--profile_dir``'s Chrome trace under its name), and its start and end,
stamped with ``time.time_ns()`` inside that range, are kept as a
:class:`Record` in a bounded recorder that a reader of the same process
takes them from (:func:`records`). ``time.time_ns()`` and the profiler's
host events share one clock, so a record can be set beside the device's
intervals of the same trace. A span given a CUDA ``device`` also records
a timing event pair on that device's current stream, one at entry and one
at exit; :func:`device_ms` reads it once the caller has synchronised.

While no profiler runs, :func:`span` returns one shared no-op context
manager: nothing is allocated, no event is made, nothing is kept.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# records kept: a few seconds of the engine's or the trainer's spans,
# several times over
MAX_RECORDS = 1 << 14

OFF = contextlib.nullcontext()
_thread_profiling = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    # (start, end) timing events on the device's stream, or None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]
    # what the span processed, where its caller counts it (the slices of
    # an ``engine.forward``), else 0
    count: int = 0


class Recorder:
    """A bounded, thread-safe store of :class:`Record` in the order the
    spans closed, which knows the latest end among those it dropped."""

    def __init__(self, maxlen: int = MAX_RECORDS):
        self._records: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._dropped_end = -1

    def keep(self, rec: Record) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._dropped_end = max(self._dropped_end,
                                        self._records[0].end_ns)
            self._records.append(rec)

    def records(self, lo_ns: int, hi_ns: int) -> List[Record]:
        """The kept records that lie within [lo_ns, hi_ns]."""
        with self._lock:
            kept = list(self._records)
        return [r for r in kept if r.start_ns >= lo_ns and r.end_ns <= hi_ns]

    def overflowed(self, lo_ns: int) -> bool:
        """Whether a record that ended at or after ``lo_ns`` was dropped."""
        return self._dropped_end >= lo_ns


_RECORDER = Recorder()


def profiling() -> bool:
    """Whether a profiler runs: ``torch.profiler``'s process-wide flag, or
    the calling thread's profiler state."""
    return (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or _thread_profiling())


class _Span:
    __slots__ = ("name", "device", "count", "_range", "_start", "_stream",
                 "_events")

    def __init__(self, name: str, device: Optional[torch.device],
                 count: int = 0):
        self.name, self.device, self.count = name, device, count

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._events = None
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        end = time.time_ns()
        _RECORDER.keep(Record(self.name, self._start, end,
                              threading.get_ident(), self._events,
                              self.count))
        self._range.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None, count: int = 0):
    """A span named ``name`` while a profiler runs (see the module's
    docstring), else the shared no-op :data:`OFF`. ``device``: time the
    span on this CUDA device's current stream too; ``count``: what it
    processed, kept in its record."""
    if not profiling():
        return OFF
    return _Span(name, device, count)


def records(lo_ns: int, hi_ns: int) -> List[Record]:
    """The records of this process's spans within [lo_ns, hi_ns]."""
    return _RECORDER.records(lo_ns, hi_ns)


def overflowed(lo_ns: int) -> bool:
    """Whether records of spans that ended at or after ``lo_ns`` were
    dropped to keep the store bounded."""
    return _RECORDER.overflowed(lo_ns)


def device_ms(rec: Record) -> Optional[float]:
    """The device ms between the record's events, once the caller has
    synchronised its device; None for a span without events, or whose
    events the device has not reached."""
    if rec.events is None:
        return None
    start, end = rec.events
    try:
        return start.elapsed_time(end)
    except RuntimeError:        # an event not recorded or not reached
        return None
