"""One run of one cell: set-up, the measured window, the reading of the
trace, the check against the reference, and the result's line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration's file (``configs/<name>.json``) and
reference (``configs/<name>.py``), its traffic mix
(``traffic/<name>.json``), whose ``kind`` names the loop that drives it
(``kinds/<kind>.py``), and each per-layer metric's reader
(``metrics/<metric>.py``). A cell, a configuration, a mix or a metric is
added by adding files and entries.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mri_superresolution_tpu")
# the traced part of the window: from this share of it, this long at most
TRACE_FROM, TRACE_SECONDS = 0.2, 3.0


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(man: dict, name: str):
    """(the configuration's dict, its reference module)."""
    entry = next(c for c in man["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    ref = _module(HERE / "configs" / f"{name}.py",
                  "benchmark_ref_" + name.replace("-", "_").replace(".", "_"))
    return cfg, ref


def reader(metric: str):
    return _module(HERE / "metrics" / f"{metric}.py",
                   "benchmark_metric_" + metric.replace(".", "_")).read


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def cell_metrics(man: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"]
                                 in names else [])]


@dataclass
class Env:
    """What a cell's loop is given."""
    workload: str
    cfg: dict
    ref: object
    traffic: dict
    seed: int
    device: object
    system: str = "program"
    notes: list = field(default_factory=list)

    def make_params(self):
        from benchmark import weights
        return weights.make(self.ref.param_spec(self.cfg), self.seed,
                            self.device)

    def clock(self):
        """A set-up timer: each call notes the seconds since the last."""
        last = [time.perf_counter()]

        def lap(what: str) -> None:
            self.sync()
            now = time.perf_counter()
            self.notes.append(f"set-up: {what} {now - last[0]:.3f} s")
            last[0] = now
        return lap

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, system: str = "program",
        man: Optional[dict] = None, cfg_over: Optional[dict] = None,
        mix_over: Optional[dict] = None) -> dict:
    """One run; returns the result's fields (``checks`` holds each
    compared number with its limit). ``system`` puts the program or the
    control under test; ``cfg_over`` and ``mix_over`` replace keys of the
    configuration and the mix (tests run a cell at a size the CPU
    holds)."""
    import torch
    from benchmark import devtrace, traffic
    man = man or manifest()
    w = next(x for x in man["workloads"] if x["name"] == workload)
    cfg, ref = config(man, w["config"])
    mix = traffic.load(w["traffic"])
    cfg.update(cfg_over or {})
    mix.update(mix_over or {})
    kind = importlib.import_module(f"benchmark.kinds.{mix['kind']}")
    env = Env(workload, cfg, ref, mix, int(seed), torch.device(device),
              system)
    if env.device.type == "cuda":
        torch.cuda.set_device(env.device)
    env.notes.append(f"set-up: imports and device "
                     f"{time.perf_counter() - t_start:.3f} s")
    st = kind.setup(env)
    if trace:
        devtrace.Tracer.warm(env.device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    tracer = devtrace.Tracer(trace, t0 + TRACE_FROM * seconds,
                             min(TRACE_SECONDS, 0.6 * seconds))
    kind.window(st, t0, seconds, tracer)
    tracer.stop()
    env.sync()
    peak = (torch.cuda.max_memory_allocated(env.device)
            if env.device.type == "cuda" else 0)
    values = dict(kind.e2e(st), setup_s=setup_s)
    wanted = cell_metrics(man, workload, trace)
    metrics, extra = {}, {}
    if trace:
        tr = tracer.read()
        if tr is None or (env.device.type == "cuda" and not tr.device):
            raise RuntimeError("the traced window holds no device operation")
        r = dict(kind.reading(st), trace=tr, traced=tracer.traced,
                 config=cfg)
        for m in wanted:
            v = reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s,
                 "breakdown": tr.breakdown()}
    else:
        for m in wanted:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    kind.release(st)
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = kind.check(st)
    correct = not getattr(st, "wrong", False) and all(
        v <= lim for v, lim in checks.values())
    return {"correct": bool(correct), "attempted": int(st.attempted),
            "failed": int(st.failed), "metrics": metrics,
            "memory_peak_bytes": int(peak), "extra": extra,
            "checks": checks, "numbers": getattr(st, "numbers", {}),
            "notes": env.notes + getattr(st, "notes", []),
            "values": values}


def device_info(chips: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _finite(v: float) -> float:
    """JSON has no infinity: a comparison that had nothing to compare
    reads as the largest double."""
    return v if math.isfinite(v) else 1.7976931348623157e308


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "benchmark once and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest()
    cell = next((x for x in man["workloads"]
                 if x["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda:0", t_start, man=man)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device = dict(device_info(cell["chips"]),
                  memory_peak_bytes=res["memory_peak_bytes"])
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if args.trace:
        device.update(busy_s=res["extra"]["busy_s"],
                      window_s=res["extra"]["window_s"])
        out["breakdown"] = res["extra"]["breakdown"]
    out["checks"] = {k: {"value": _finite(v), "limit": lim}
                     for k, (v, lim) in res["checks"].items()}
    for note in res["notes"]:
        print(note, file=sys.stderr)
    print(f"card: {card_line()}", file=sys.stderr)
    for k, (v, lim) in res["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
