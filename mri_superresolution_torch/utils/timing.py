"""Device timing by CUDA events."""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters``
    calls after ``warmup`` untimed ones. Needs a CUDA device."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, inputs, iters: int = 20, warmup: int = 3,
                 stream=None) -> float:
    """Device time of ``fn(inp)`` in ms, with cold caches and without the
    host's share. ``iters`` calls, taking ``inputs`` in turn, are captured
    in one CUDA graph with every result kept, so each call writes memory of
    its own. The graph is replayed, and the time is the median over 5
    replays, by CUDA events, divided by ``iters``. Give inputs whose total
    is well past the card's L2 (see :func:`l2_cold_copies`); then each call
    finds its input and its output cold. A replay launches the kernels
    back to back, so a call whose host side (checks, allocation, launch)
    takes longer than its kernel is timed by its kernel; :func:`cuda_ms`
    times both. ``fn`` runs ``warmup`` times first, outside the graph, and
    counts launches only while it is captured. ``stream``: the stream to
    capture on (a backward through ``torch.autograd`` runs on its
    forward's stream, so capture it on the stream its forward ran on).
    Needs a CUDA device."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        keep = [fn(inputs[i % len(inputs)]) for i in range(iters)]
    graph.replay()                                  # untimed
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(5):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    del keep, graph
    return sorted(means)[2]


def l2_cold_copies(x: torch.Tensor) -> list:
    """``x`` and enough copies of it that together they hold more than
    twice the L2 of ``x``'s card: inputs for :func:`cuda_ms_cold`."""
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    n = 2 * l2 // (x.numel() * x.element_size()) + 1
    return [x] + [x.clone() for _ in range(n)]
