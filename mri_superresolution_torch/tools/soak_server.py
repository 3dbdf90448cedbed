"""Mixed slice and volume soak of the serving daemon, on the card.

    python -m mri_superresolution_torch.tools.soak_server [--seconds 120]
        [--slice_clients 6] [--volume_clients 2] [--hw 128] [--batch 16]
        [--vol_slices 24] [--base_filters 16] [--max_pending 1024] [--cpu]

The JAX package's ``tools/soak_server.py``, with its flags and defaults,
run by the port alone. A ``serve_http`` daemon in this process serves a
unet of seeded random weights (bf16) on the zero-copy raw path
(``normalize_inputs``, ``transpose_io``, int16 out; ``max_batch`` 64, a
3 ms window). After one warm-up slice request (2 slices) and one volume,
client threads of both kinds run for ``--seconds``: slice clients POST
(n, hw, hw) int16 ``.npy`` stacks (n from 1 to ``--batch``) to /upscale,
volume clients an (hw, hw, ``--vol_slices``) int16 NIfTI to
/upscale_volume. Then the books must balance (``check_books``):

- every response decodes, with the right shape and dtype;
- no client saw an error;
- /metrics' request count equals the slices served plus the warm-up's;
- the queue drained (depth 0) and the daemon counted no error;
- ``peak_pending`` stayed within ``--max_pending``;

and the run ends on ``SOAK OK``. Everything runs on the card unless
``--cpu``.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request
from typing import Dict, List

import numpy as np

MAX_BATCH, WINDOW_MS, REQUEST_TIMEOUT_S = 64, 3.0, 1800
WARM_SLICES = 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Mixed slice and volume soak "
                                 "of the serving daemon")
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--slice_clients", type=int, default=6)
    ap.add_argument("--volume_clients", type=int, default=2)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16,
                    help="most slices a slice request carries")
    ap.add_argument("--vol_slices", type=int, default=24)
    ap.add_argument("--base_filters", type=int, default=16)
    ap.add_argument("--max_pending", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU")
    return ap.parse_args(argv)


def build_engine(args, device):
    """The soak's engine: the unet at ``--base_filters`` with seeded random
    weights, bf16, on the raw path with int16 outputs."""
    import torch

    from mri_superresolution_torch.config import ModelConfig
    from mri_superresolution_torch.infer.engine import InferenceEngine
    from mri_superresolution_torch.models import build_model

    cfg = ModelConfig(base_filters=args.base_filters)
    params = build_model(cfg, generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    return InferenceEngine(cfg, params, bf16=True, device=device,
                           normalize_inputs=True, transpose_io=True,
                           out_dtype=np.int16)


def _post(base: str, path: str, body: bytes) -> bytes:
    req = urllib.request.Request(base + path, data=body)
    with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as resp:
        return resp.read()


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def run_soak(engine, args) -> Dict:
    """Serve ``engine`` with ``serve_http`` on 127.0.0.1 (a free port),
    warm it, run the clients for ``args.seconds`` and read /metrics; then
    shut the daemon down. Returns the books: slices and volumes each kind
    got back, the warm-up's slices, responses that did not decode right
    (``bad``) and errors, /metrics, each request's latency by kind, the
    seconds, and each client's first request (its input and response)."""
    from mri_superresolution_torch import nifti
    from mri_superresolution_torch.infer.server import serve_http

    hw, n_vol = args.hw, args.vol_slices
    server = serve_http(engine, host="127.0.0.1", port=0,
                        max_batch=MAX_BATCH, batch_window_ms=WINDOW_MS,
                        max_pending=args.max_pending,
                        request_timeout_s=REQUEST_TIMEOUT_S)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    books = {"slices": 0, "volumes": 0, "vol_slices": n_vol,
             "warm_slices": WARM_SLICES + n_vol, "bad": [], "errors": [],
             "latency_ms": {"slice": [], "volume": []}, "first": []}
    lock = threading.Lock()
    try:
        # the two shapes warm: a slice stack, and a volume through the
        # chunked raw path
        rng = np.random.default_rng(0)
        _post(base, "/upscale", _npy(
            (rng.random((WARM_SLICES, hw, hw)) * 900).astype(np.int16)))
        vol = (rng.random((hw, hw, n_vol)) * 900).astype(np.int16)
        vol_blob = nifti.save_bytes(vol)
        _post(base, "/upscale_volume", vol_blob)
        stop = time.monotonic() + args.seconds

        def client(kind: str, i: int) -> None:
            r = np.random.default_rng(i)
            first = True
            while time.monotonic() < stop:
                if kind == "slice":
                    n = int(r.integers(1, args.batch + 1))
                    x = (r.random((n, hw, hw)) * 900).astype(np.int16)
                    path, body, want = "/upscale", _npy(x), (n, 2 * hw,
                                                            2 * hw)
                else:
                    x, path, body = vol, "/upscale_volume", vol_blob
                    want = (2 * hw, 2 * hw, n_vol)
                t0 = time.perf_counter()
                try:
                    reply = _post(base, path, body)
                except Exception as e:    # the books count every failure
                    with lock:
                        books["errors"].append(
                            f"{kind}[{i}]: {type(e).__name__} {e}")
                    return
                ms = (time.perf_counter() - t0) * 1e3
                try:
                    y = (np.load(io.BytesIO(reply)) if kind == "slice"
                         else nifti.load_bytes(reply, raw=True)[0])
                    ok = y.shape == want and y.dtype == np.int16
                except Exception as e:    # a body that does not decode
                    y, ok = f"{type(e).__name__} {e}", False
                with lock:
                    if not ok:
                        books["bad"].append(
                            f"{kind}[{i}]: {getattr(y, 'shape', y)} "
                            f"{getattr(y, 'dtype', '')}, want {want} int16")
                        return
                    books["latency_ms"][kind].append(ms)
                    if kind == "slice":
                        books["slices"] += len(y)
                    else:
                        books["volumes"] += 1
                    if first:
                        books["first"].append({"kind": kind, "client": i,
                                               "input": x, "output": y})
                first = False

        threads = ([threading.Thread(target=client, args=("slice", i))
                    for i in range(args.slice_clients)]
                   + [threading.Thread(target=client, args=("volume", i))
                      for i in range(args.volume_clients)])
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        books["seconds"] = time.monotonic() - t0
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            books["metrics"] = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(10)
    return books


def direct_output(engine, first: Dict) -> np.ndarray:
    """What ``engine.upscale_batch`` gives for a client's first request,
    in its response's layout: a slice stack as posted; a volume's
    (n, w, h) C-order view of its F-order voxels, as the raw path serves
    it, transposed back to (2h, 2w, n)."""
    x = first["input"]
    if first["kind"] == "slice":
        return engine.upscale_batch(x)
    return engine.upscale_batch(np.ascontiguousarray(x.transpose(2, 1, 0))).T


def check_books(books: Dict, max_pending: int) -> None:
    """The soak's five checks; raises RuntimeError naming each that
    fails."""
    m = books["metrics"]
    stats = m["stats"]
    served = books["slices"] + books["volumes"] * books["vol_slices"]
    failed: List[str] = []
    if books["bad"]:
        failed.append(f"responses of the wrong shape or dtype: "
                      f"{books['bad'][:5]}")
    if books["errors"]:
        failed.append(f"client errors: {books['errors'][:5]}")
    if stats["requests"] != served + books["warm_slices"]:
        failed.append(f"/metrics counts {stats['requests']} slice requests, "
                      f"the clients got {served} back and the warm-up "
                      f"{books['warm_slices']}")
    if m["queue_depth"] != 0 or stats["errors"] != 0:
        failed.append(f"queue depth {m['queue_depth']} and {stats['errors']} "
                      f"errors after the soak, want 0 and 0")
    if stats["peak_pending"] > max_pending:
        failed.append(f"peak_pending {stats['peak_pending']} over "
                      f"--max_pending {max_pending}")
    if failed:
        raise RuntimeError("soak books do not balance: " + "; ".join(failed))


def _pct(values: List[float], q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))] if v else \
        float("nan")


def summary(books: Dict) -> Dict:
    """The soak's rates: slices served (by kind) and aggregate slices/s,
    p50 and p99 latency by client kind, the batch-size histogram and the
    daemon's counters."""
    served = books["slices"] + books["volumes"] * books["vol_slices"]
    stats = books["metrics"]["stats"]
    return {"seconds": books["seconds"], "slices": books["slices"],
            "volumes": books["volumes"], "served_slices": served,
            "slices_per_s": served / books["seconds"],
            "latency_ms": {k: {"requests": len(v), "p50": _pct(v, 0.5),
                               "p99": _pct(v, 0.99)}
                           for k, v in books["latency_ms"].items()},
            "batch_size_hist": books["metrics"]["batch_size_hist"],
            "requests": stats["requests"], "batches": stats["batches"],
            "peak_pending": stats["peak_pending"],
            "errors": stats["errors"],
            "queue_depth": books["metrics"]["queue_depth"]}


def main(argv=None) -> Dict:
    """Soak the daemon and check its books; returns them. Raises
    RuntimeError when they do not balance."""
    from mri_superresolution_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    books = run_soak(build_engine(args, device), args)
    s = summary(books)
    print(f"soak {s['seconds']:.0f}s: {s['slices']} slices + {s['volumes']} "
          f"volumes = {s['served_slices']} served ({s['slices_per_s']:.1f} "
          f"slices/s aggregate)")
    for kind, lat in s["latency_ms"].items():
        print(f"{kind} clients: {lat['requests']} requests, p50 "
              f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms")
    print(f"metrics: requests={s['requests']} batches={s['batches']} "
          f"peak_pending={s['peak_pending']} errors={s['errors']} "
          f"queue_depth={s['queue_depth']} "
          f"batch_size_hist={s['batch_size_hist']}")
    check_books(books, args.max_pending)
    print("SOAK OK")
    return books


if __name__ == "__main__":
    main()
