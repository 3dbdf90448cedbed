"""Serving daemon: dynamic batching and an HTTP front end over the engine.

An own copy of the JAX package's ``infer/server.py`` for the port's
``InferenceEngine`` (``infer/engine.py``):

- ``DynamicBatcher``: requests that arrive within a short window are
  coalesced into one batched forward per (H, W, dtype) group. The pending
  queue is bounded (``max_pending``): when it is full, ``submit`` raises
  :class:`QueueFullError` and the HTTP front end answers 503 with
  Retry-After instead of buffering without limit.
- ``serve_http``: a stdlib ``ThreadingHTTPServer``. POST /upscale takes an
  ``.npy`` of (H, W) or (N, H, W) and returns the 2x outputs as ``.npy``;
  POST /upscale_volume streams a NIfTI volume through the batcher in
  z-chunks (bounded memory); GET /healthz and GET /metrics report state.
  Bodies are capped (``max_body_bytes``: 413) and waits are bounded
  (``request_timeout_s``: 504, the request abandoned so that the worker
  never spends a forward on it).

**One thread calls the backend.** Only the batcher's worker thread calls
``upscale_batch``; the HTTP handler threads touch numpy and the batcher's
queue only. On the card this is a rule, not a convenience: the kernels'
arrival counters are one buffer a device and kernel
(``kernels/_build.counters``), which assumes one stream; PyTorch's
current stream and ``inference_mode`` are per thread; and the engine's
device-to-host side stream and its events are used by whichever thread
calls it. A process runs one batcher's worker at a time on a card.

Raw serving (``--serve_raw``): when the engine normalizes its inputs on
the card (``normalize_inputs``, with ``transpose_io``), /upscale_volume
submits the volume's stored voxels (float64 as fp32): a NIfTI volume's
F-order (h, w, n) buffer read in C order is (n, w, h), the layout
``transpose_io`` takes, and its (n, 2w, 2h) outputs are already the
output file's F-order bytes. Packed ``out_dtype`` responses (int16/uint8)
carry the NIfTI ``scl_slope`` that decodes them to [0, 1].

Defects of the JAX package's daemon fixed here (the JAX package keeps
them): a gzip upload of several members decodes as ``gzip.decompress``
does (JAX answers 400 on the second member); a timed-out wait counts
``abandoned`` under the lock; an (N, H, W) /upscale that meets a full
queue halfway abandons the slices it had queued before it answers 503, so
the worker runs no forward for them; the transposed /upscale contract
under ``--serve_raw`` is documented (``serve_http``); and
``server_close()`` joins the handler threads in flight (the stdlib's
``ThreadingHTTPServer`` runs them as daemon threads, which it does not
join, so a SIGTERM could end the process under a request still being
answered).
"""

from __future__ import annotations

import inspect
import io
import json
import logging
import threading
import time
import zlib
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("mri_superresolution_torch.serve")

__all__ = ["DynamicBatcher", "QueueFullError", "serve_http"]


class QueueFullError(RuntimeError):
    """The batcher's bounded pending queue is full (backpressure)."""


class _Request:
    __slots__ = ("image", "event", "result", "error", "abandoned")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False     # the worker drops an abandoned request


class DynamicBatcher:
    """Coalesce concurrent single-image requests into batched forwards.

    One worker thread drains the queue: after the first request arrives it
    waits up to ``batch_window_ms`` for more (bounded by ``max_batch``),
    groups the pending requests by (H, W, dtype) and runs one
    ``upscale_batch`` a group. The worker is the only thread that calls
    the backend (the module's rule), so engine state (the int8 state
    machine, the side stream) needs no lock.

    ``max_pending`` bounds the queue (0 = unbounded): ``submit`` on a full
    queue raises :class:`QueueFullError` at once.

    Each group is zero-padded to the next power of two, clamped to
    ``max_batch``, and the pad rows' outputs are dropped. So a
    stream of arbitrary coalesced sizes reaches the engine in at most
    log2(max_batch) + 1 batch sizes a shape: the set of padded shapes that
    a CUDA graph of the forward (ROADMAP A4) captures once each. Groups are
    not padded while the engine's int8 self-calibration counts slices
    (``quant_calibrating``): pad rows would count as calibration data. Zero
    rows lower the int8 routing's foreground fraction, which can only send
    a batch to bf16, the side that keeps quality.

    A backend whose ``upscale_batch`` takes ``pad`` (a serving artifact,
    ``infer/export.py``) is called with ``pad=True``, so that a slice of a
    shape it has no program for is padded to one it has, as the JAX
    batcher does; its programs take any batch size, so its groups go at
    their own size.
    """

    def __init__(self, backend, max_batch: int = 64,
                 batch_window_ms: float = 5.0, max_pending: int = 0):
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._backend = backend
        self._kwargs = ({"pad": True} if "pad" in inspect.signature(
            backend.upscale_batch).parameters else {})
        # engines that normalize on the card take any integer or float
        # dtype; everything else gets float32 at submit
        self._raw_input = bool(getattr(backend, "normalize_inputs", False))
        self.max_batch = int(max_batch)
        self.max_pending = max(0, int(max_pending))
        self.batch_window_s = float(batch_window_ms) / 1e3
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._closed = False
        self.stats: Dict[str, float] = {
            "requests": 0, "batches": 0, "batched_requests": 0,
            "max_batch_seen": 0, "errors": 0, "rejected": 0,
            "abandoned": 0, "peak_pending": 0}
        # device-group size -> count (/metrics)
        self.batch_size_hist: Dict[int, int] = defaultdict(int)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mri-sr-batcher")
        self._worker.start()

    # ---- client side ----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def snapshot(self):
        """(stats, batch-size histogram, queue depth), copied under the
        lock: the worker mutates them."""
        with self._cv:
            return dict(self.stats), dict(self.batch_size_hist), \
                len(self._queue)

    def submit_blocking(self, image01: np.ndarray,
                        deadline: Optional[float] = None) -> _Request:
        """:meth:`submit`, but on a full queue wait for room instead of
        raising: for a producer that has committed to a response (the
        volume endpoint) and applies backpressure. Raises TimeoutError past
        ``deadline`` (a ``time.monotonic()`` time)."""
        first = True
        while True:
            try:
                return self.submit(image01, _count_reject=first)
            except QueueFullError:
                first = False
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "queue stayed full past the request deadline")
                time.sleep(0.02)

    def submit(self, image01: np.ndarray,
               _count_reject: bool = True) -> _Request:
        """Enqueue one (H, W) image without blocking; pair with
        :meth:`wait`. A caller with N slices enqueues them all, so that
        they coalesce into one batch. Raises :class:`QueueFullError` when
        the bounded queue is full (``_count_reject=False``, for
        ``submit_blocking``'s retries, leaves ``rejected`` alone)."""
        if image01.ndim != 2:
            raise ValueError(f"expected a 2-D image, got {image01.shape}")
        if self._raw_input:
            img = np.asarray(image01)
            if img.dtype == np.float64:     # the card normalizes in fp32
                img = img.astype(np.float32)
        else:
            img = np.asarray(image01, np.float32)
        req = _Request(img)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self.max_pending and len(self._queue) >= self.max_pending:
                if _count_reject:
                    self.stats["rejected"] += 1
                raise QueueFullError(
                    f"pending queue full ({self.max_pending} requests)")
            self._queue.append(req)
            self.stats["peak_pending"] = max(self.stats["peak_pending"],
                                             len(self._queue))
            self._cv.notify()
        return req

    def abandon(self, reqs) -> None:
        """Mark requests whose caller gave up: the worker drops each one
        that it has not taken yet. Each one not served yet counts in
        ``abandoned``."""
        with self._cv:
            for r in reqs:
                if not r.abandoned and not r.event.is_set():
                    r.abandoned = True
                    self.stats["abandoned"] += 1

    def wait(self, req: _Request, timeout: Optional[float] = None
             ) -> np.ndarray:
        if not req.event.wait(timeout):
            self.abandon([req])
            raise TimeoutError("upscale request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def upscale(self, image01: np.ndarray,
                timeout: Optional[float] = None) -> np.ndarray:
        """(H, W) -> (2H, 2W). Blocks until served; raises whatever the
        backend raised for this request's group."""
        return self.wait(self.submit(image01), timeout)

    def close(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout)

    # ---- worker side ----------------------------------------------------

    def _take(self) -> List[_Request]:
        """Block for the first request, then linger ``batch_window_s`` for
        more (up to max_batch); abandoned requests are dropped here."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return []
            deadline = time.monotonic() + self.batch_window_s
            while (len(self._queue) < self.max_batch
                   and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    break
            batch, self._queue = (self._queue[:self.max_batch],
                                  self._queue[self.max_batch:])
            return [r for r in batch if not r.abandoned]

    def _run(self) -> None:
        while True:
            reqs = self._take()
            if not reqs:
                if self._closed:
                    return
                continue
            groups: Dict[Tuple, List[_Request]] = defaultdict(list)
            for r in reqs:
                groups[(r.image.shape, r.image.dtype.str)].append(r)
            for (shape, _dt), group in groups.items():
                try:
                    batch = np.stack([r.image for r in group])
                    if not self._kwargs and not getattr(
                            self._backend, "quant_calibrating", False):
                        target = min(1 << (len(group) - 1).bit_length(),
                                     self.max_batch)
                        if target > len(group):
                            batch = np.concatenate(
                                [batch, np.zeros((target - len(group),)
                                                 + shape, batch.dtype)])
                    out = self._backend.upscale_batch(batch,
                                                      **self._kwargs)
                    for r, y in zip(group, out):
                        r.result = np.asarray(y)
                except BaseException as e:  # delivered to the callers
                    with self._cv:
                        self.stats["errors"] += len(group)
                    for r in group:
                        r.error = e
                finally:
                    with self._cv:
                        self.stats["requests"] += len(group)
                        self.stats["batches"] += 1
                        self.batch_size_hist[len(group)] += 1
                        if len(group) > 1:
                            self.stats["batched_requests"] += len(group)
                        self.stats["max_batch_seen"] = max(
                            self.stats["max_batch_seen"], len(group))
                    for r in group:
                        r.event.set()


def _load_npy(data: bytes, raw_input: bool) -> np.ndarray:
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    if raw_input:
        # the engine normalizes on the card: ship the native dtype
        return np.asarray(arr)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    return np.asarray(arr, np.float32)


def _dump_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


# ------------------------------------------------- streaming volume serving

class _ByteCursor:
    """Incremental reader over in-memory ``.nii`` / ``.nii.gz`` bytes.

    Plain bodies are sliced; gzip bodies decompress through
    ``zlib.decompressobj`` one chunk at a time, so a request's transient
    memory stays O(z-chunk). A gzip body of several members (concatenated
    ``.gz`` streams, which ``gzip.decompress`` reads as one) is read member
    after member: at the end of one, a new decompressor starts on the bytes
    after it, zero padding skipped as ``gzip`` skips it."""

    _FEED = 1 << 20

    def __init__(self, body: bytes):
        self._body = body
        self._pos = 0
        self._gz = body[:2] == b"\x1f\x8b"
        self._z = zlib.decompressobj(31) if self._gz else None
        self._buf = bytearray()
        self._pending = b""

    @property
    def gz(self) -> bool:
        return self._gz

    def _next_input(self) -> bytes:
        if self._pending:
            data, self._pending = self._pending, b""
            return data
        data = self._body[self._pos:self._pos + self._FEED]
        self._pos += len(data)
        return data

    def _next_member(self) -> bool:
        """After a member's end: start the next member's decompressor on
        the bytes that follow it; False when only zero padding is left."""
        rest = self._z.unused_data + self._pending
        self._pending = b""
        while True:
            rest = rest.lstrip(b"\x00")
            if rest:
                break
            rest = self._body[self._pos:self._pos + self._FEED]
            self._pos += len(rest)
            if not rest:
                return False
        self._z = zlib.decompressobj(31)
        self._pending = rest
        return True

    def read(self, n: int) -> bytes:
        if self._z is None:
            b = self._body[self._pos:self._pos + n]
            self._pos += len(b)
            return bytes(b)
        while len(self._buf) < n:
            if self._z.eof and not self._next_member():
                break
            data = self._next_input()
            if not data:
                self._buf += self._z.flush()
                break
            self._buf += self._z.decompress(data, max(n - len(self._buf),
                                                      self._FEED))
            self._pending = self._z.unconsumed_tail
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def _serve_volume_streaming(batcher: DynamicBatcher, body: bytes, handler,
                            timeout: Optional[float]) -> None:
    """NIfTI bytes in -> 2x-in-plane NIfTI bytes out, decoded, served and
    written in z-chunks, so that peak memory is O(body + chunk). Two input
    paths:

    - raw (the engine normalizes on the card): the F-order buffer's C-order
      (n, w, h) slices are submitted in the stored dtype (float64 as fp32);
      with ``transpose_io`` the (2w, 2h) outputs are the output file's
      F-order slice bytes. A negative scl_slope flips intensity order and is
      refused.
    - host (an engine of [0, 1] inputs): scl scaling, the per-slice
      percentile window and min-max on the host (the infer_volume CLI's
      math), fp32 in.

    A plain upload's response streams with an exact Content-Length (the
    output geometry is known from the header); a gzip upload's response is
    compressed chunk by chunk into memory and sent at the end. Two chunks
    are in flight, so that the card computes one while the host encodes the
    other.
    """
    from mri_superresolution_torch import nifti
    from mri_superresolution_torch.ops.functional import unit_slope

    cur = _ByteCursor(body)
    head = cur.read(nifti.HDR_SIZE)
    hdr, order = nifti.read_header(head)
    if hdr.datatype not in nifti._DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {hdr.datatype}")
    shape = hdr.shape
    if len(shape) == 4:
        shape = shape[:3]          # timepoint 0 is served
    if len(shape) != 3:
        raise ValueError(f"expected a 3D volume, got {len(shape)}D")
    h, w, n = shape
    if min(h, w, n) < 1:
        raise ValueError(f"degenerate volume shape {shape}")
    off = int(hdr.vox_offset)
    if off < nifti.HDR_SIZE:
        raise ValueError(f"bad vox_offset {off}")
    cur.read(off - nifti.HDR_SIZE)

    in_dtype = np.dtype(nifti._DTYPES[hdr.datatype]).newbyteorder(order)
    raw = batcher._raw_input
    slope, inter = hdr.scl_slope, hdr.scl_inter
    if raw and np.isfinite(slope) and slope < 0:
        raise ValueError("raw serving requires a non-negative scl_slope "
                         "(a negative slope flips intensity order, which "
                         "the card's normalize does not absorb)")
    transpose = bool(getattr(batcher._backend, "transpose_io", False))
    out_dtype = np.dtype(getattr(batcher._backend, "out_dtype", np.float32))

    if not cur.gz:
        # a plain body's voxel byte count is known: refuse a truncated
        # upload with a 400 before the 200 is committed
        need = off + h * w * n * in_dtype.itemsize
        if len(body) < need:
            raise ValueError(
                f"truncated NIfTI body: {len(body)} bytes < {need} "
                f"needed for {h}x{w}x{n} {in_dtype.name}")

    zooms = list(hdr.zooms) + [1.0] * 3
    out_head = nifti.encode_header(
        (2 * h, 2 * w, n), out_dtype,
        zooms=(zooms[0] / 2.0, zooms[1] / 2.0, zooms[2]),
        scl_slope=unit_slope(out_dtype))
    total = len(out_head) + 2 * h * 2 * w * n * out_dtype.itemsize

    if cur.gz:
        zc = zlib.compressobj(1, zlib.DEFLATED, 31)
        pieces = [zc.compress(out_head)]

        def emit(b):
            pieces.append(zc.compress(b))
    else:
        # past this point an error can only truncate the stream, which
        # the client sees against the Content-Length
        handler._responded = True
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", str(total))
        handler.end_headers()
        handler.wfile.write(out_head)
        emit = handler.wfile.write

    slice_bytes = h * w * in_dtype.itemsize
    chunk_slices = max(1, batcher.max_batch)
    left = [n]

    def read_chunk():
        """The next (c, w, h) array of the F-order byte stream (a NIfTI
        volume's F-order (h, w, n) buffer is a C-order (n, w, h) array)."""
        want = min(chunk_slices, left[0])
        if want <= 0:
            return None
        raw_b = cur.read(want * slice_bytes)
        if len(raw_b) < want * slice_bytes:
            raise ValueError("truncated NIfTI voxel data")
        left[0] -= want
        arr = np.frombuffer(raw_b, dtype=in_dtype).reshape(want, w, h)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        return arr

    deadline = (time.monotonic() + timeout) if timeout else None

    def submit_chunk(arr):
        # the response is committed: wait for room in the queue (bounded
        # by the request's deadline) instead of shedding mid-stream
        if raw:
            if not transpose:      # card normalize, host (h, w) layout
                arr = np.ascontiguousarray(arr.transpose(0, 2, 1))
            return [batcher.submit_blocking(s, deadline) for s in arr]
        # host path: scl scaling, per-slice percentile window, min-max
        data = arr.astype(np.float64)
        if np.isfinite(slope) and slope != 0 and (slope, inter) != (1.0, 0.0):
            data = data * slope + inter
        stack = np.ascontiguousarray(data.transpose(0, 2, 1)).astype(
            np.float32)
        lo, hi = np.percentile(stack, (0.5, 99.5), axis=(1, 2),
                               keepdims=True)
        stack = np.clip(stack, lo, hi)
        span = hi - lo
        stack = np.where(span > 0,
                         (stack - lo) / np.where(span > 0, span, 1), stack)
        return [batcher.submit_blocking(s, deadline) for s in stack]

    def emit_chunk(reqs):
        ys = [batcher.wait(r, timeout) for r in reqs]
        if raw and transpose:
            # (2w, 2h) C-order outputs are the file's F-order slice bytes
            emit(np.ascontiguousarray(np.stack(ys)).tobytes())
        else:
            emit(np.ascontiguousarray(
                np.stack(ys).transpose(0, 2, 1)).tobytes())

    window: deque = deque()
    while True:
        arr = read_chunk()
        if arr is None:
            break
        window.append(submit_chunk(arr))
        if len(window) > 2:
            emit_chunk(window.popleft())
    while window:
        emit_chunk(window.popleft())

    if cur.gz:
        pieces.append(zc.flush())
        blob = b"".join(pieces)
        handler._responded = True
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", str(len(blob)))
        handler.end_headers()
        handler.wfile.write(blob)


def serve_http(backend, host: str = "127.0.0.1", port: int = 8476,
               max_batch: int = 64, batch_window_ms: float = 5.0,
               describe: str = "", max_pending: int = 2048,
               max_body_bytes: int = 512 << 20,
               request_timeout_s: float = 300.0):
    """Build the HTTP server (it does not block): a ``ThreadingHTTPServer``
    with a started ``DynamicBatcher`` as ``.batcher``. The caller owns the
    loop and the shutdown order: ``serve_forever()``, then
    ``server_close()`` (joins the handler threads in flight: the drain),
    then ``batcher.close()`` (``cli/serve.py`` does this).

    Endpoints:
    - ``POST /upscale``: body an ``.npy`` of (H, W) or (N, H, W), float in
      [0, 1] (uint8 and uint16 are scaled to it); response an ``.npy`` of
      the 2x outputs. On a raw backend (``--serve_raw``: the engine
      normalizes on the card, with ``transpose_io``) the array goes to the
      engine in its own dtype and in the NIfTI layout: a posted (W, H)
      array, the C-order view of a NIfTI volume's F-order slice, is read
      as the transpose of the (H, W) image it upscales, and the response
      is (2W, 2H), the transpose of that image's (2H, 2W) output. To
      upscale an (H, W) image there, post its transpose and transpose the
      response.
    - ``POST /upscale_volume``: body ``.nii`` or ``.nii.gz`` bytes,
      decoded, served and re-encoded in z-chunks (bounded memory); response
      the 2x-in-plane NIfTI (halved in-plane zooms, gzipped if the upload
      was, packed int16/uint8 with the decoding ``scl_slope`` when the
      engine packs).
    - ``GET /healthz``: JSON of the backend's description and the batcher's
      stats, and for a serving artifact its header's mode, shapes, model
      type, routing, raw input and output dtype under ``artifact``.
    - ``GET /metrics``: JSON of the stats, the queue depth, the batch-size
      histogram, the engine's int8 routing counts (``quant_batches``) and
      the server's limits.

    Load safety: bodies over ``max_body_bytes`` get 413 before any read; a
    request without Content-Length 411; a full queue 503 with Retry-After
    (an (N, H, W) request abandons the slices it had queued); a request
    unserved after ``request_timeout_s`` 504, and it is abandoned; a bad
    body 400 with the reason.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = DynamicBatcher(backend, max_batch=max_batch,
                             batch_window_ms=batch_window_ms,
                             max_pending=max_pending)
    limits = {"max_pending": max_pending, "max_body_bytes": max_body_bytes,
              "request_timeout_s": request_timeout_s,
              "max_batch": max_batch, "batch_window_ms": batch_window_ms}

    def upscale_stack(arr: np.ndarray) -> np.ndarray:
        """Every slice of (N, H, W) queued before the first wait, so that
        they coalesce; on a full queue the ones queued are abandoned."""
        reqs = []
        try:
            for a in arr:
                reqs.append(batcher.submit(a))
        except QueueFullError:
            batcher.abandon(reqs)
            raise
        try:
            return np.stack([batcher.wait(r, request_timeout_s)
                             for r in reqs])
        except BaseException:
            batcher.abandon(reqs)
            raise

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # to logging, not stderr
            logger.debug("http: " + fmt % args)

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/octet-stream",
                   headers: Optional[Dict[str, str]] = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict,
                  headers: Optional[Dict[str, str]] = None):
            self._reply(code, json.dumps(payload).encode(),
                        "application/json", headers)

        def do_GET(self):
            if self.path == "/healthz":
                stats, _, _ = batcher.snapshot()
                payload = {"status": "ok", "backend": describe,
                           "stats": stats}
                header = getattr(backend, "header", None)
                if header is not None:   # a serving artifact
                    payload["artifact"] = {
                        k: header[k] for k in (
                            "model_type", "mode", "shapes", "routed",
                            "serve_raw", "raw_dtype", "out_dtype", "bf16")}
                return self._json(200, payload)
            if self.path == "/metrics":
                stats, hist, depth = batcher.snapshot()
                payload = {
                    "stats": stats,
                    "queue_depth": depth,
                    "batch_size_hist": {str(k): v
                                        for k, v in sorted(hist.items())},
                    "limits": limits,
                }
                q = getattr(backend, "_quant_batches", None)
                if q is not None:
                    payload["quant_batches"] = dict(q)
                return self._json(200, payload)
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/upscale", "/upscale_volume"):
                return self._json(404, {"error": "not found"})
            cl = self.headers.get("Content-Length")
            if cl is None:
                return self._json(411, {"error": "Content-Length required"})
            try:
                n = int(cl)
            except ValueError:
                return self._json(400, {"error": "bad Content-Length"})
            if n > max_body_bytes:
                return self._json(
                    413, {"error": f"body {n} bytes exceeds the "
                                   f"{max_body_bytes}-byte limit"})
            try:
                body = self.rfile.read(n)
                if self.path == "/upscale_volume":
                    return _serve_volume_streaming(batcher, body, self,
                                                   request_timeout_s)
                arr = _load_npy(body, batcher._raw_input)
                if arr.ndim == 2:
                    out = batcher.upscale(arr, timeout=request_timeout_s)
                elif arr.ndim == 3:
                    out = upscale_stack(arr)
                else:
                    raise ValueError(f"expected 2-D or 3-D, got {arr.shape}")
                self._reply(200, _dump_npy(out))
            except QueueFullError as e:
                if getattr(self, "_responded", False):
                    logger.warning(f"{self.path} overloaded mid-stream")
                    return
                self._json(503, {"error": str(e)},
                           headers={"Retry-After": "1"})
            except TimeoutError as e:
                logger.warning(f"{self.path} timed out: {e}")
                if not getattr(self, "_responded", False):
                    self._json(504, {"error": str(e)})
            except Exception as e:  # the client gets the reason
                logger.warning(f"{self.path} failed: {e}")
                if not getattr(self, "_responded", False):
                    self._json(400, {"error": str(e)})

    class Server(ThreadingHTTPServer):
        # handler threads that server_close() joins: the drain. The
        # stdlib's daemon handler threads are not joined, and one still
        # writing its response when the process exits is killed mid-call
        daemon_threads = False

    Handler.timeout = request_timeout_s     # a stalled client's socket
    server = Server((host, port), Handler)
    server.batcher = batcher  # closed by the caller after server_close()
    logger.info(f"Serving on http://{host}:{server.server_address[1]} "
                f"(max_batch={max_batch}, window={batch_window_ms}ms, "
                f"max_pending={max_pending}, "
                f"raw_input={batcher._raw_input})")
    return server
