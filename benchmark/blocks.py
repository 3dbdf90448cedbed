"""The device time of the spans a model marks inside each of the engine's
forwards (``program_span``), a slice: for SwinIR's ``swin.attn`` and
``swin.mlp``, every block's two halves.

The event pairs of the ``name`` spans that lie within a window's complete,
timed ``engine.forward`` spans (the same thread) are summed, and divided by
the slices of those forwards, which each ``engine.forward`` record counts.
The forwards alternate between batches of 64 and 32 slices, so a median of
forwards would jump between the two sizes; this sum does not. None where
the run gives nothing to read: the control, a program without spans, no
timed forward in the window, a block span the device did not time, or a
forward that does not count its slices. 0 where the window's forwards ran
no ``name`` span.
"""

from __future__ import annotations

from typing import Optional

from benchmark import spans


def device_ms_per_slice(r, name: str) -> Optional[float]:
    rec = spans._recorder()
    recs = spans.window_records(r)
    if rec is None or recs is None:
        return None
    total, slices, timed = 0.0, 0, 0
    for fwd in spans._inside(r, "engine.forward"):
        if rec.device_ms(fwd) is None:
            continue
        ms = [rec.device_ms(s) for s in recs if s.name == name
              and s.thread == fwd.thread and s.start_ns >= fwd.start_ns
              and s.end_ns <= fwd.end_ns]
        if None in ms:
            return None
        timed += 1
        total += sum(ms)
        slices += getattr(fwd, "count", 0)
    if timed == 0:
        return None
    if total == 0.0:
        return 0.0
    return total / slices if slices > 0 else None
