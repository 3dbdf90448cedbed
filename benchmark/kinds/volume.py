"""Whole volumes served back to back, as ``infer_volume --serve_raw
--out_dtype int16`` serves a directory of studies.

Parameters (the traffic file): ``slices``, ``height``, ``width`` of each
volume, ``pool`` volumes made from the seed at set-up, ``batch_size``
slices a forward (the CLI's default 64), ``depth`` batches in flight
(``upscale_batches``' window), ``gain`` and ``noise`` of the stored int16
voxels, ``sample`` output slices compared in the check.

Each volume is page-locked and served through the engine's
``upscale_batches``; its int16 output is assembled on the host as the
CLI assembles it. ``serve_slices_per_s`` counts every output slice that
reached the host inside the window, over the window's seconds. One
assembled output slice of every volume served, drawn from the seed, is
kept; the check compares a sample of them, drawn from the seed, with the
reference.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import measure, reference, systems, traffic


def setup(env):
    t = env.traffic
    st = SimpleNamespace(env=env, attempted=0, failed=0, notes=[])
    clock = env.clock()
    st.pool = [traffic.stored_int16(env.seed, i, t["slices"], t["height"],
                                    t["width"], t["gain"], t["noise"],
                                    env.device) for i in range(t["pool"])]
    st.params = env.make_params()
    clock("inputs and weights")
    st.engine = systems.make_engine(env.system, env.cfg, env.ref, st.params,
                                    env.device)
    clock("program built")
    st.pick = traffic.rng(env.seed, 6).integers(0, t["slices"], 1 << 16)
    st.kept = []              # (volume, slice, output), one a volume
    # warm-up: every shape the window uses (the full and the last batch)
    for v in st.pool[:2]:
        _serve(st, v)
    clock("warm-up")
    return st


# the host's phases of one volume, timed apart in the window
PHASES = ("lock", "batches", "drain_unlock", "assemble")


def _serve(st, vol: np.ndarray, on_batch=None, times=None):
    """One volume through the engine's window; the (n, 2w, 2h) output.
    ``times`` gets the seconds of each of :data:`PHASES`."""
    t = st.env.traffic
    bs = t["batch_size"]
    starts = range(0, vol.shape[0], bs)
    outs = []
    clock = [time.perf_counter()]
    with st.engine.page_locked(vol):
        clock.append(time.perf_counter())
        for out in st.engine.upscale_batches(
                (vol[s:s + bs] for s in starts), depth=t["depth"]):
            outs.append(out)
            if on_batch is not None:
                on_batch(out)
        clock.append(time.perf_counter())
    clock.append(time.perf_counter())
    sr = np.concatenate(outs, axis=0)
    clock.append(time.perf_counter())
    if times is not None:
        times.append(np.diff(clock))
    if sr.shape != (vol.shape[0], 2 * vol.shape[1], 2 * vol.shape[2]) or \
            sr.dtype != np.int16:
        raise RuntimeError(f"volume served as {sr.shape} {sr.dtype}")
    return sr


def _keep(st, k: int, vi: int, sr: np.ndarray) -> None:
    """Keeps one output slice of the k-th volume served, its index drawn
    from the seed before the window (a copy: the engine's page-locked
    buffers go back to its allocator)."""
    i = int(st.pick[k % len(st.pick)])
    st.kept.append((vi, i, sr[i].copy()))


def window(st, t0: float, seconds: float, tracer) -> None:
    t_end = t0 + seconds
    st.t0, st.t_end, st.window_s = t0, t_end, seconds
    st.counted = st.batches = st.traced_batches = 0
    st.work = []              # (previous batch's end, this one's, slices)
    last = [t0]

    def on_batch(out):
        now = time.perf_counter()
        st.batches += 1
        if tracer.on:
            st.traced_batches += 1
        if now <= t_end:
            st.counted += out.shape[0]
            st.work.append((last[0], now, out.shape[0]))
        last[0] = now
        tracer.tick(now)

    k = 0
    times = []
    st.volume_spans = []      # (start, end, seconds in the engine's window)
    while time.perf_counter() < t_end:
        vi = k % len(st.pool)
        vol = st.pool[vi]
        a = time.perf_counter()
        with tracer.span("volume"):
            sr = _serve(st, vol, on_batch, times)
        st.volume_spans.append((a, time.perf_counter(), float(times[-1][1])))
        with tracer.span("keep"):
            _keep(st, k, vi, sr)
        st.attempted += vol.shape[0]
        k += 1
    st.volumes = k
    med = np.median(np.array(times), axis=0) * 1e3
    st.notes.append(f"volume: {k} volumes; host ms a volume, median: " +
                    ", ".join(f"{p} {v:.3f}" for p, v in zip(PHASES, med)))



def e2e(st) -> dict:
    return {"serve_slices_per_s": measure.rate(st.counted, st.window_s)}


def reading(st) -> dict:
    t = st.env.traffic
    return {"t0": st.t0, "t_end": st.t_end, "work": st.work,
            "volumes": st.volume_spans,
            "flops_per_slice": st.env.ref.flops_per_slice(
                st.env.cfg, t["height"], t["width"]),
            "batches_traced": st.traced_batches,
            "slices_per_forward": st.attempted / max(1, st.batches),
            "b1_site_hw": (t["height"], t["width"])}


def release(st) -> None:
    st.engine = None


def check(st) -> dict:
    env = st.env
    lim = env.cfg["limits"]["serve"]
    r = traffic.rng(env.seed, 9)
    k = min(env.traffic["sample"], len(st.kept))
    st.sample = [st.kept[int(i)] for i in
                 np.sort(r.choice(len(st.kept), k, replace=False))]
    if not st.sample:
        return {"max_gap": (float("inf"), lim["max_gap"]),
                "mean_gap": (float("inf"), lim["mean_gap"])}
    got, want = [], []
    with torch.no_grad(), reference.fp32():
        fwd = lambda x: env.ref.forward(st.params, x)  # noqa: E731
        for i in range(0, len(st.sample), 16):
            part = st.sample[i:i + 16]
            raw = torch.from_numpy(np.stack(
                [st.pool[vi][si] for vi, si, _ in part])).to(env.device)
            want.append(reference.serve_raw_int16(fwd, raw).cpu())
            got.append(torch.from_numpy(np.stack([o for _, _, o in part])))
    big, mean = reference.code_gaps(torch.cat(got), torch.cat(want))
    return {"max_gap": (big, lim["max_gap"]),
            "mean_gap": (mean, lim["mean_gap"])}
