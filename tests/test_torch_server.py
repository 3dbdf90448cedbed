"""The port's serving daemon (``infer/server.py``, ``cli/serve.py``) on the
CPU, case for case with the JAX package's tests/test_server.py (its
spatial cases wait for ROADMAP A14; its artifact cases are in
tests/test_torch_export_cli.py), with the port's
engine; the four defects of the JAX daemon that the port fixes, each
beside the JAX daemon's behaviour; the rule that only the batcher's worker
thread calls the backend; and the two daemons against each other on the
same weights and inputs (fp32): /upscale within rtol 1e-4, the raw int16
/upscale_volume within one code and with the same header bytes.

Every HTTP call has a timeout, every join too; servers bind port 0 and
shut down in a ``finally``. Engines: the unet at base filters 16, slices of
16^2-32^2. A fifth fix has its test too: the port's ``server_close()``
joins the handler threads in flight, which SIGTERM's drain needs."""

import gzip
import http.client
import io
import json
import os
import resource
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mri_superresolution_tpu import nifti as jnifti
from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.infer import server as jserver
from mri_superresolution_tpu.infer.engine import (
    InferenceEngine as JaxEngine)
from mri_superresolution_tpu.models import UNetSuperRes, init_params
from mri_superresolution_torch import nifti
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.infer import (DynamicBatcher, InferenceEngine,
                                             QueueFullError, serve_http)
from mri_superresolution_torch.infer import server as tserver
from mri_superresolution_torch.infer.engine import preprocess_image_array
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(base_filters=16)


@pytest.fixture(scope="module")
def params():
    return build_model(CFG, generator=torch.Generator().manual_seed(0)
                       ).state_dict()


@pytest.fixture(scope="module")
def engine(params):
    return InferenceEngine(CFG, params, bf16=False, device="cpu")


@pytest.fixture(scope="module")
def raw_engine(params):
    """The --serve_raw engine: raw inputs normalized on the card's side,
    transposed IO, int16 outputs."""
    return InferenceEngine(CFG, params, bf16=False, device="cpu",
                           normalize_inputs=True, transpose_io=True,
                           out_dtype=np.int16)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    server.batcher.close()
    thread.join(10)


def _post(base, path, data, timeout=60):
    req = urllib.request.Request(base + path, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _load(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b))


class _Recording:
    """Wraps a backend: the batch sizes and calling threads of its
    ``upscale_batch`` calls."""

    def __init__(self, backend):
        self._b = backend
        self.sizes, self.threads = [], set()
        for a in ("normalize_inputs", "transpose_io", "out_dtype",
                  "quant_calibrating", "_quant_batches"):
            if hasattr(backend, a):
                setattr(self, a, getattr(backend, a))

    def upscale_batch(self, batch):
        self.threads.add(threading.get_ident())
        self.sizes.append(batch.shape[0])
        return self._b.upscale_batch(batch)


class _SlowBackend:
    """Blocks in upscale_batch until released: pins queue and timeout
    behaviour without device timing races."""

    def __init__(self):
        self.release = threading.Event()
        self.slices_served = 0
        self.calls = 0

    def upscale_batch(self, batch):
        self.release.wait(30)
        self.calls += 1
        self.slices_served += batch.shape[0]
        n, h, w = batch.shape
        return np.zeros((n, 2 * h, 2 * w), np.float32)


# --------------------------------------------------------- the batcher

def test_batcher_coalesces_concurrent_requests(engine, rng):
    images = [rng.random((16, 16), dtype=np.float32) for _ in range(12)]
    want = engine.upscale_batch(np.stack(images))
    b = DynamicBatcher(engine, max_batch=32, batch_window_ms=300.0)
    try:
        results = [None] * len(images)

        def client(i):
            results[i] = b.upscale(images[i], timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for i in range(len(images)):
            np.testing.assert_allclose(results[i], want[i], rtol=1e-5,
                                       atol=1e-6)
        assert b.stats["max_batch_seen"] > 1, b.stats
        assert b.stats["requests"] == len(images)
    finally:
        b.close()


def test_batcher_groups_by_shape(engine, rng):
    a = rng.random((16, 16), dtype=np.float32)
    c = rng.random((16, 24), dtype=np.float32)
    b = DynamicBatcher(engine, max_batch=8, batch_window_ms=200.0)
    try:
        ra, rc = b.submit(a), b.submit(c)
        ya, yc = b.wait(ra, 60), b.wait(rc, 60)
        np.testing.assert_allclose(ya, engine.upscale_image(a), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(yc, engine.upscale_image(c), rtol=1e-5,
                                   atol=1e-6)
        assert ya.shape == (32, 32) and yc.shape == (32, 48)
        assert b.stats["batches"] == 2
    finally:
        b.close()


def test_batcher_error_propagation_keeps_the_worker():
    """A group whose backend call raises delivers the error to its callers
    (counted in ``errors``); the worker keeps serving."""

    class Picky:
        def upscale_batch(self, batch):
            if batch.shape[1] != 8:
                raise ValueError("no program for this shape")
            n, h, w = batch.shape
            return np.ones((n, 2 * h, 2 * w), np.float32)

    b = DynamicBatcher(Picky(), max_batch=8, batch_window_ms=1.0)
    try:
        assert b.upscale(np.zeros((8, 8)), timeout=30).shape == (16, 16)
        with pytest.raises(ValueError, match="no program"):
            b.upscale(np.zeros((16, 16)), timeout=30)
        assert b.upscale(np.zeros((8, 8)), timeout=30).shape == (16, 16)
        assert b.stats["errors"] == 1 and b.stats["requests"] == 3
    finally:
        b.close()


def test_batcher_pads_engine_batches_to_pow2(engine, rng):
    """Groups reach the engine padded to the next power of two, clamped to
    max_batch; the pad rows' outputs are dropped."""
    rec = _Recording(engine)
    b = DynamicBatcher(rec, max_batch=6, batch_window_ms=300.0)
    try:
        imgs = rng.random((5, 16, 16), dtype=np.float32)
        reqs = [b.submit(x) for x in imgs]
        outs = np.stack([b.wait(r, 60) for r in reqs])
        np.testing.assert_allclose(outs, engine.upscale_batch(imgs),
                                   rtol=1e-5, atol=1e-6)
        reqs = [b.submit(x) for x in imgs[:3]]
        [b.wait(r, 60) for r in reqs]
        assert b.stats["batches"] == 2 and b.stats["requests"] == 8
        assert rec.sizes == [6, 4]   # 5 -> min(8, 6); 3 -> 4
    finally:
        b.close()


def test_batcher_rejects_bad_max_batch(engine):
    with pytest.raises(ValueError, match="max_batch"):
        DynamicBatcher(engine, max_batch=0)


def test_batcher_skips_padding_while_calibrating(params, rng):
    """Pad rows never count as int8 calibration slices: while the engine
    calibrates, groups run at their own size; once frozen, padding
    resumes."""
    eng = InferenceEngine(CFG, params, bf16=False, device="cpu",
                          quant="int8", quant_calib_slices=5)
    assert eng.quant_calibrating
    b = DynamicBatcher(eng, max_batch=8, batch_window_ms=150.0)
    try:
        reqs = [b.submit(rng.random((16, 16), dtype=np.float32))
                for _ in range(3)]
        for r in reqs:
            b.wait(r, 120)
        assert eng._calib_seen == 3
        for _ in range(2):
            b.upscale(rng.random((16, 16), dtype=np.float32), timeout=120)
        assert not eng.quant_calibrating
    finally:
        b.close()


def test_batcher_bounded_queue_rejects():
    be = _SlowBackend()
    b = DynamicBatcher(be, max_batch=1, batch_window_ms=1.0, max_pending=2)
    try:
        img = np.zeros((8, 8), np.float32)
        b.submit(img)              # taken by the worker, blocked in it
        time.sleep(0.3)
        b.submit(img)
        b.submit(img)
        with pytest.raises(QueueFullError):
            b.submit(img)
        assert b.stats["rejected"] == 1 and b.stats["peak_pending"] == 2
    finally:
        be.release.set()
        b.close()


def test_request_timeout_abandons_queued_work():
    be = _SlowBackend()
    b = DynamicBatcher(be, max_batch=1, batch_window_ms=1.0)
    try:
        img = np.zeros((8, 8), np.float32)
        first = b.submit(img)
        time.sleep(0.2)
        doomed = b.submit(img)
        with pytest.raises(TimeoutError):
            b.wait(doomed, timeout=0.05)
        assert b.stats["abandoned"] == 1
        be.release.set()
        b.wait(first, timeout=30)
        assert b.upscale(img, timeout=30).shape == (16, 16)
        assert be.slices_served == 2      # the abandoned one never ran
    finally:
        be.release.set()
        b.close()


# ---------------------------------------------------------------- HTTP

def test_http_server_roundtrip(engine, rng):
    """/upscale of (N, H, W) coalesces; uint8 is scaled as the CLI does;
    /healthz reports; a bad body is a 400; /upscale_volume of a .nii.gz
    (host path) returns the 2x-in-plane .nii.gz."""
    server = serve_http(engine, port=0, max_batch=16, batch_window_ms=50.0,
                        describe="test-engine")
    thread, base = _start(server)
    try:
        vol = rng.random((5, 16, 16)).astype(np.float32)
        out = _load(_post(base, "/upscale", _npy(vol)))
        np.testing.assert_allclose(out, engine.upscale_batch(vol),
                                   rtol=1e-5, atol=1e-6)
        img8 = (rng.random((16, 16)) * 255).astype(np.uint8)
        out8 = _load(_post(base, "/upscale", _npy(img8)))
        np.testing.assert_allclose(
            out8, engine.upscale_image(img8.astype(np.float32) / 255.0),
            rtol=1e-5, atol=1e-6)
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["backend"] == "test-engine"
        assert health["stats"]["requests"] >= 6
        assert health["stats"]["max_batch_seen"] > 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/upscale", b"garbage")
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/nope", b"x")
        assert ei.value.code == 404

        raw_vol = (rng.random((16, 16, 6)) * 900).astype(np.float32)
        blob = nifti.save_bytes(raw_vol, zooms=(2.0, 2.0, 3.0), compress=True)
        out_blob = _post(base, "/upscale_volume", blob)
        assert out_blob[:2] == b"\x1f\x8b"
        sr, hdr = nifti.load_bytes(out_blob)
        assert sr.shape == (32, 32, 6) and hdr.zooms == (1.0, 1.0, 3.0)
        want = np.stack([engine.upscale_image(
            preprocess_image_array(raw_vol[:, :, k])) for k in range(6)],
            axis=2)
        np.testing.assert_allclose(sr, want, rtol=1e-5, atol=1e-5)
    finally:
        _stop(server, thread)


def test_http_503_when_queue_full_and_504_on_timeout():
    be = _SlowBackend()
    server = serve_http(be, port=0, max_batch=1, batch_window_ms=1.0,
                        max_pending=1, request_timeout_s=0.5)
    thread, base = _start(server)
    try:
        payload = _npy(np.zeros((8, 8), np.float32))
        errs = []

        def fire():
            try:
                _post(base, "/upscale", payload)
            except urllib.error.HTTPError as e:
                errs.append(e.code)

        t1 = threading.Thread(target=fire)
        t1.start()
        time.sleep(0.3)
        t2 = threading.Thread(target=fire)
        t2.start()
        time.sleep(0.2)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/upscale", payload)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "1"
        t1.join(30)
        t2.join(30)
        assert errs and all(c == 504 for c in errs)
    finally:
        be.release.set()
        _stop(server, thread)


def test_http_body_cap_and_missing_length():
    be = _SlowBackend()
    be.release.set()
    server = serve_http(be, port=0, max_body_bytes=1024)
    thread, base = _start(server)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/upscale", _npy(np.zeros((64, 64), np.float32)))
        assert ei.value.code == 413
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=30)
        conn.putrequest("POST", "/upscale", skip_accept_encoding=True)
        conn.endheaders()
        assert conn.getresponse().status == 411
        conn.close()
    finally:
        _stop(server, thread)


def test_metrics_endpoint(engine, rng):
    server = serve_http(engine, port=0, max_batch=8, batch_window_ms=30.0)
    thread, base = _start(server)
    try:
        _post(base, "/upscale", _npy(rng.random((3, 16, 16)).astype(
            np.float32)))
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["stats"]["requests"] >= 3 and m["queue_depth"] == 0
        assert sum(m["batch_size_hist"].values()) == m["stats"]["batches"]
        assert m["limits"]["max_batch"] == 8
        assert m["quant_batches"] == {"int8": 0, "bf16": 0}
    finally:
        _stop(server, thread)


def test_stress_sixteen_clients_mixed_shapes(engine, rng):
    """16 concurrent clients over mixed shapes: every request served with
    the right shape, no shedding under a 256-deep queue, and the histogram
    accounts for every batch."""
    server = serve_http(engine, port=0, max_batch=8, batch_window_ms=20.0,
                        max_pending=256)
    thread, base = _start(server)
    results, failures = [], []
    shapes = [(16, 16), (24, 24), (16, 24)]
    imgs = [rng.random(shapes[i % 3]).astype(np.float32) for i in range(16)]

    def client(i):
        try:
            out = _load(_post(base, "/upscale", _npy(imgs[i]), timeout=120))
            results.append((imgs[i].shape, out.shape))
        except urllib.error.HTTPError as e:
            failures.append(e.code)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not failures and len(results) == 16
        for shape, out_shape in results:
            assert out_shape == (2 * shape[0], 2 * shape[1])
        stats, hist, _ = server.batcher.snapshot()
        assert stats["peak_pending"] <= 256
        assert sum(hist.values()) == stats["batches"]
        assert stats["requests"] == 16
    finally:
        _stop(server, thread)


def test_only_the_worker_thread_calls_the_backend(engine, rng):
    """Under 16 concurrent clients (single slices and stacks) the backend
    sees exactly one calling thread: the batcher's worker."""
    rec = _Recording(engine)
    server = serve_http(rec, port=0, max_batch=8, batch_window_ms=10.0)
    thread, base = _start(server)
    try:
        bodies = [_npy(rng.random((16, 16) if i % 2 else (3, 16, 16))
                       .astype(np.float32)) for i in range(16)]
        outs = [None] * 16
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, _post(base, "/upscale", bodies[i], timeout=120)))
            for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(o is not None for o in outs)
        assert rec.threads == {server.batcher._worker.ident}
        assert len(rec.sizes) >= 2
    finally:
        _stop(server, thread)


@pytest.mark.parametrize("compress", [False, True])
def test_volume_endpoint_raw_zero_copy(raw_engine, rng, compress):
    """/upscale_volume on a --serve_raw engine: int16 in, int16 out with
    scl_slope 1/32767, equal to the engine on the volume's F-order slices
    (one batch of 4 = max_batch, so the same shape as the direct call)."""
    vol = (rng.random((16, 16, 4)) * 900).astype(np.int16)
    blob = nifti.save_bytes(vol, zooms=(2.0, 2.0, 3.0), scl_slope=2.0,
                            compress=compress)
    server = serve_http(raw_engine, port=0, max_batch=4, batch_window_ms=5.0)
    thread, base = _start(server)
    try:
        out_blob = _post(base, "/upscale_volume", blob, timeout=120)
        assert (out_blob[:2] == b"\x1f\x8b") == compress
        sr, hdr = nifti.load_bytes(out_blob, raw=True)
        assert sr.dtype == np.int16 and sr.shape == (32, 32, 4)
        assert hdr.zooms == (1.0, 1.0, 3.0)
        assert abs(hdr.scl_slope - 1.0 / 32767.0) < 1e-12
        want = raw_engine.upscale_batch(np.ascontiguousarray(vol.T))
        np.testing.assert_array_equal(sr, want.T)
    finally:
        _stop(server, thread)


def test_upscale_endpoint_raw_native_dtype(raw_engine, rng):
    server = serve_http(raw_engine, port=0, max_batch=4)
    thread, base = _start(server)
    try:
        img = (rng.random((16, 16)) * 4000).astype(np.uint16)
        out = _load(_post(base, "/upscale", _npy(img.T), timeout=120))
        np.testing.assert_array_equal(out,
                                      raw_engine.upscale_batch(img.T[None])[0])
    finally:
        _stop(server, thread)


def test_volume_endpoint_streams_bounded_memory():
    """A 50 MB int16 body streams in z-chunks: the process's peak RSS
    grows by far less than the 1.3 GB a whole-volume float path holds
    (ru_maxrss is a process-wide high-water mark: in a suite the check can
    only pass trivially, never fail falsely)."""

    class InstantRaw:
        normalize_inputs = True
        transpose_io = True
        out_dtype = np.dtype(np.int16)

        def upscale_batch(self, batch):
            n, w, h = batch.shape
            return np.zeros((n, 2 * w, 2 * h), np.int16)

    blob = nifti.save_bytes(np.zeros((256, 256, 400), np.int16),
                            zooms=(1.0, 1.0, 1.0))
    server = serve_http(InstantRaw(), port=0, max_batch=32,
                        batch_window_ms=1.0)
    thread, base = _start(server)
    try:
        before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        out = _post(base, "/upscale_volume", blob, timeout=120)
        after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        assert (after - before) < 700 * 1024          # KiB
        sr, _ = nifti.load_bytes(out, raw=True)
        assert sr.shape == (512, 512, 400) and sr.dtype == np.int16
    finally:
        _stop(server, thread)


def test_volume_endpoint_negative_paths(raw_engine, rng):
    """Corrupt bytes, truncated plain and gzip bodies, a negative
    scl_slope on the raw path: 400 before any byte streams; a 4D volume
    serves timepoint 0."""
    server = serve_http(raw_engine, port=0, max_batch=4)
    thread, base = _start(server)
    try:
        vol = (rng.random((16, 16, 4)) * 900).astype(np.int16)
        blob = nifti.save_bytes(vol)
        gz = gzip.compress(blob)
        for body in (b"not a nifti at all", blob[:len(blob) // 2],
                     gz[:len(gz) // 2], nifti.save_bytes(vol, scl_slope=-1.0)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, "/upscale_volume", body)
            assert ei.value.code == 400
        vol4 = (rng.random((16, 16, 4, 3)) * 900).astype(np.int16)
        sr, _ = nifti.load_bytes(_post(base, "/upscale_volume",
                                       nifti.save_bytes(vol4), timeout=120),
                                 raw=True)
        assert sr.shape == (32, 32, 4)
        np.testing.assert_array_equal(sr, raw_engine.upscale_batch(
            np.ascontiguousarray(vol4[:, :, :, 0].T)).T)
    finally:
        _stop(server, thread)


# ------------------------------------------- the JAX daemon's four defects

def _two_member_gzip(blob: bytes) -> bytes:
    """``blob`` gzipped as two concatenated members, split inside the
    voxel data; ``gzip.decompress`` reads it as one stream."""
    cut = len(blob) - (len(blob) - 352) // 2
    return gzip.compress(blob[:cut]) + gzip.compress(blob[cut:])


def test_multi_member_gzip_volume(raw_engine, rng):
    """A .nii.gz of two gzip members: the JAX daemon answers 400
    ("truncated NIfTI voxel data"); the port's decodes it as
    ``gzip.decompress`` does and answers 200 with the voxels of the
    one-member upload."""
    vol = (rng.random((16, 16, 4)) * 900).astype(np.int16)
    blob = nifti.save_bytes(vol, zooms=(2.0, 2.0, 3.0))
    two = _two_member_gzip(blob)
    assert gzip.decompress(two) == blob
    cur = tserver._ByteCursor(two + b"\x00" * 8)      # gzip's zero padding
    assert cur.read(len(blob) + 100) == blob
    jcur = jserver._ByteCursor(two)
    assert jcur.read(len(blob)) != blob               # stops at member 1

    class JaxRawStub:
        normalize_inputs = True
        transpose_io = True
        out_dtype = np.dtype(np.int16)

        def upscale_batch(self, batch):
            n, w, h = batch.shape
            return np.zeros((n, 2 * w, 2 * h), np.int16)

    jsrv = jserver.serve_http(JaxRawStub(), port=0, max_batch=4)
    jthread, jbase = _start(jsrv)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(jbase, "/upscale_volume", two)
        assert ei.value.code == 400
        assert b"truncated NIfTI voxel data" in ei.value.read()
    finally:
        _stop(jsrv, jthread)

    server = serve_http(raw_engine, port=0, max_batch=4)
    thread, base = _start(server)
    try:
        got, ghdr = nifti.load_bytes(_post(base, "/upscale_volume", two,
                                           timeout=120), raw=True)
        want, whdr = nifti.load_bytes(_post(
            base, "/upscale_volume", gzip.compress(blob), timeout=120),
            raw=True)
        np.testing.assert_array_equal(got, want)
        assert ghdr.zooms == whdr.zooms == (1.0, 1.0, 3.0)
    finally:
        _stop(server, thread)


class _LockCheckingStats(dict):
    """Records, for each change of ``abandoned``, whether the batcher's
    condition was held."""

    def __init__(self, base, cv):
        super().__init__(base)
        self.cv, self.held = cv, []

    def __setitem__(self, k, v):
        if k == "abandoned":
            self.held.append(self.cv._is_owned())
        super().__setitem__(k, v)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_abandoned_counts_under_the_lock(package):
    """A timed-out wait bumps ``abandoned``: the JAX batcher does it
    without its lock (two waiters timing out together can lose a count),
    the port's under it."""
    be = _SlowBackend()
    cls = jserver.DynamicBatcher if package == "jax" else DynamicBatcher
    b = cls(be, max_batch=1, batch_window_ms=1.0)
    b.stats = _LockCheckingStats(b.stats, b._cv)
    try:
        img = np.zeros((8, 8), np.float32)
        b.submit(img)
        time.sleep(0.2)
        doomed = [b.submit(img) for _ in range(2)]
        for r in doomed:
            with pytest.raises(TimeoutError):
                b.wait(r, timeout=0.05)
        assert b.stats["abandoned"] == 2
        assert b.stats.held == ([False, False] if package == "jax"
                                else [True, True])
    finally:
        be.release.set()
        b.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_queue_full_mid_stack_abandons_what_it_queued(package):
    """An (N, H, W) /upscale that meets a full queue after queueing some
    of its slices answers 503. The JAX daemon leaves those slices queued,
    and its worker runs a forward for them; the port's abandons them, and
    its worker runs none."""
    be = _SlowBackend()
    mod = jserver if package == "jax" else tserver
    server = mod.serve_http(be, port=0, max_batch=1, batch_window_ms=1.0,
                            max_pending=3, request_timeout_s=30)
    thread, base = _start(server)
    try:
        blocker = threading.Thread(target=lambda: _post(
            base, "/upscale", _npy(np.zeros((8, 8), np.float32))))
        blocker.start()
        time.sleep(0.3)                    # the worker holds it
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/upscale", _npy(np.zeros((5, 8, 8), np.float32)))
        assert ei.value.code == 503
        be.release.set()
        blocker.join(30)
        deadline = time.monotonic() + 10
        while server.batcher.queue_depth and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)
        stats, _, depth = server.batcher.snapshot()
        assert depth == 0
        if package == "jax":
            assert be.calls == 4 and stats["requests"] == 4
        else:
            assert be.calls == 1 and stats["requests"] == 1
            assert stats["abandoned"] == 3
    finally:
        be.release.set()
        _stop(server, thread)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_server_close_drains_requests_in_flight(package):
    """``server_close()`` after ``shutdown()``, with a request still
    waiting on the backend: the stdlib's daemon handler threads let the
    JAX daemon's return at once (a process that exits then kills the
    handler mid-answer); the port's joins the handler, which answers 200
    once the backend is released."""
    be = _SlowBackend()
    mod = jserver if package == "jax" else tserver
    server = mod.serve_http(be, port=0, max_batch=1, batch_window_ms=1.0)
    thread, base = _start(server)
    got = []
    client = threading.Thread(target=lambda: got.append(_post(
        base, "/upscale", _npy(np.zeros((8, 8), np.float32)))))
    try:
        client.start()
        time.sleep(0.3)                       # the worker holds it
        server.shutdown()
        closer = threading.Thread(target=server.server_close)
        closer.start()
        closer.join(0.5)
        assert closer.is_alive() == (package == "port")
        be.release.set()
        closer.join(30)
        client.join(30)
        assert not closer.is_alive() and len(got) == 1
    finally:
        be.release.set()
        server.batcher.close()
        thread.join(10)


def test_raw_upscale_is_transposed(params, rng):
    """Under --serve_raw, /upscale takes the NIfTI layout: a posted (W, H)
    array is the transpose of the (H, W) image it upscales, and the
    response is (2W, 2H), the transpose of that image's (2H, 2W) output,
    as on the JAX daemon. Posting a non-square image's transpose and
    transposing the response gives the standard-layout raw engine's
    output."""
    raw = InferenceEngine(CFG, params, bf16=False, device="cpu",
                          normalize_inputs=True, transpose_io=True)
    std = InferenceEngine(CFG, params, bf16=False, device="cpu",
                          normalize_inputs=True)
    img = (rng.random((16, 24)) * 1000).astype(np.int16)     # (H, W)
    server = serve_http(raw, port=0, max_batch=4)
    thread, base = _start(server)
    try:
        out = _load(_post(base, "/upscale", _npy(img), timeout=120))
        assert out.shape == (32, 48)         # posted (16, 24) read as (W, H)
        np.testing.assert_allclose(
            out, std.upscale_batch(np.ascontiguousarray(img.T)[None])[0].T,
            rtol=1e-5, atol=1e-6)
        out_t = _load(_post(base, "/upscale", _npy(img.T), timeout=120))
        assert out_t.shape == (48, 32)
        np.testing.assert_allclose(out_t.T, std.upscale_batch(img[None])[0],
                                   rtol=1e-5, atol=1e-6)
    finally:
        _stop(server, thread)
    assert "(W, H)" in tserver.serve_http.__doc__


# ------------------------------------------------------------- the CLI

def _serve(*args, timeout=120):
    return subprocess.run([sys.executable, "-m",
                           "mri_superresolution_torch.cli.serve", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_serve_cli_help():
    r = _serve("--help")
    assert r.returncode == 0
    for flag in ("--artifact", "--max_batch", "--batch_window_ms", "--quant",
                 "--tta", "--port", "--serve_raw", "--out_dtype", "--cpu",
                 "--max_pending", "--request_timeout_s"):
        assert flag in r.stdout
    assert "(W, H)" in r.stdout and "(2W, 2H)" in r.stdout


@pytest.mark.parametrize("flags,item", [
    (("--artifact", "m.mrisrx"), "JAX package"),
    (("--num_devices", "3", "--spatial_shards", "2"),
     "spatial_shards=2 must divide the 3 mesh devices")])
def test_serve_cli_refuses_unported_modes(flags, item, tmp_path):
    """``--artifact`` is served since A12, but not a JAX package's
    artifact (jax.export programs): exit 1, naming the package. A
    ``--spatial_shards`` that does not divide the device count exits 1
    with the JAX engine's error."""
    if flags[0] == "--artifact":
        (tmp_path / flags[1]).write_bytes(b"MRISRX1\n" + b"\0" * 16)
        flags = (flags[0], str(tmp_path / flags[1]))
    else:
        ckpt.save_checkpoint(
            str(tmp_path / "final_model_unet"),
            build_model(ModelConfig(base_filters=16)).state_dict(),
            meta={"config": {"model": {"model_type": "unet",
                                       "base_filters": 16}}})
    r = _serve("--cpu", "--checkpoint_dir", str(tmp_path), *flags)
    assert r.returncode == 1
    assert item in r.stderr


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_healthy(proc, base):
    deadline = time.monotonic() + 90
    while True:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, ConnectionError):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)


def test_serve_cli_num_devices_matches_the_jax_mesh_engine(tmp_path, rng):
    """``--cpu --num_devices 8``: a posted batch of 5 slices is padded to
    8 and split over 8 CPU devices; the answer within atol 1e-5 of the
    JAX engine with ``num_devices=8`` on the same checkpoint (fp32)."""
    jp = jax.tree_util.tree_map(np.asarray, init_params(
        UNetSuperRes(base_filters=16), jax.random.key(0), (16, 16)))
    ckpt.save_checkpoint(str(tmp_path / "final_model_unet"),
                         state_dict_from_jax(jp),
                         meta={"config": {"model": {"model_type": "unet",
                                                    "base_filters": 16}}})
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mri_superresolution_torch.cli.serve",
         "--checkpoint_dir", str(tmp_path), "--port", str(port), "--cpu",
         "--no_bf16", "--num_devices", "8", "--max_batch", "8"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT,
                                    OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        health = _wait_healthy(proc, base)
        assert "devices=8" in json.dumps(health)
        x = rng.random((5, 16, 16)).astype(np.float32)
        got = _load(_post(base, "/upscale", _npy(x)))
        want = JaxEngine(JaxModelConfig(base_filters=16), jp, bf16=False,
                         num_devices=8).upscale_batch(x)
        assert got.shape == want.shape == (5, 32, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stdout.close()
        proc.stderr.close()


def test_serve_cli_serves_and_drains_on_sigterm(params, tmp_path, rng):
    """The CLI on the CPU from a checkpoint: /healthz answers, one /upscale
    comes back right, and a SIGTERM while a request is in flight lets it
    complete before the process exits 0."""
    ckpt.save_checkpoint(str(tmp_path / "final_model_unet"), params,
                         meta={"config": {"model": {"model_type": "unet",
                                                    "base_filters": 16}}})
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mri_superresolution_torch.cli.serve",
         "--checkpoint_dir", str(tmp_path), "--port", str(port), "--cpu",
         "--no_bf16", "--batch_window_ms", "300"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    assert json.loads(r.read())["status"] == "ok"
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        img = rng.random((16, 16)).astype(np.float32)
        want = InferenceEngine(CFG, params, bf16=False,
                               device="cpu").upscale_image(img)
        np.testing.assert_allclose(_load(_post(base, "/upscale", _npy(img))),
                                   want, rtol=1e-5, atol=1e-6)
        got = []
        t = threading.Thread(target=lambda: got.append(
            _post(base, "/upscale", _npy(img), timeout=60)))
        t.start()
        time.sleep(0.1)                  # inside the 300 ms batch window
        proc.send_signal(signal.SIGTERM)
        t.join(60)
        assert proc.wait(60) == 0
        np.testing.assert_allclose(_load(got[0]), want, rtol=1e-5, atol=1e-6)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stdout.close()
        proc.stderr.close()


# ---------------------------------------------- the two daemons, same input

@pytest.fixture(scope="module")
def both_engines():
    """JAX's and the port's fp32 engines on the same weights (JAX's init,
    carried by ``utils/weights``): plain, and raw with int16 outputs."""
    params = jax.tree_util.tree_map(np.asarray, init_params(
        UNetSuperRes(base_filters=16), jax.random.key(0), (16, 16)))
    sd = state_dict_from_jax(params)
    raw = dict(normalize_inputs=True, transpose_io=True, out_dtype=np.int16)
    return {"jax": (JaxEngine(JaxModelConfig(base_filters=16), params,
                              bf16=False),
                    JaxEngine(JaxModelConfig(base_filters=16), params,
                              bf16=False, **raw)),
            "port": (InferenceEngine(CFG, sd, bf16=False, device="cpu"),
                     InferenceEngine(CFG, sd, bf16=False, device="cpu",
                                     **raw))}


def _daemon_outputs(package, engines, posts, max_batch=4):
    mod = jserver if package == "jax" else tserver
    server = mod.serve_http(engines, port=0, max_batch=max_batch,
                            batch_window_ms=5.0)
    thread, base = _start(server)
    try:
        return [_post(base, path, body, timeout=300) for path, body in posts]
    finally:
        _stop(server, thread)


def test_upscale_matches_the_jax_daemon(both_engines):
    """/upscale of a slice and of a (4, H, W) stack: the port's daemon
    within rtol 1e-4 of JAX's (fp32)."""
    r = np.random.default_rng(9)
    posts = [("/upscale", _npy(r.random((16, 16)).astype(np.float32))),
             ("/upscale", _npy(r.random((4, 16, 16)).astype(np.float32)))]
    want = _daemon_outputs("jax", both_engines["jax"][0], posts)
    got = _daemon_outputs("port", both_engines["port"][0], posts)
    for g, w in zip(got, want):
        g, w = _load(g), _load(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("compress", [False, True])
def test_raw_int16_volume_matches_the_jax_daemon(both_engines, compress):
    """/upscale_volume of an int16 volume on the raw int16 daemons: the
    header bytes equal, every voxel within one code."""
    r = np.random.default_rng(10)
    vol = (r.random((16, 16, 4)) * 900).astype(np.int16)
    blob = nifti.save_bytes(vol, zooms=(1.5, 1.5, 3.0), scl_slope=0.5,
                            compress=compress)
    posts = [("/upscale_volume", blob)]
    (want,) = _daemon_outputs("jax", both_engines["jax"][1], posts)
    (got,) = _daemon_outputs("port", both_engines["port"][1], posts)
    if compress:
        want, got = gzip.decompress(want), gzip.decompress(got)
    assert len(got) == len(want) and got[:352] == want[:352]
    g, ghdr = nifti.load_bytes(got, raw=True)
    w, _ = jnifti.load_bytes(want, raw=True)
    assert g.dtype == w.dtype == np.int16 and g.shape == w.shape
    assert int(np.abs(g.astype(np.int32) - w).max()) <= 1
    assert ghdr.zooms == (0.75, 0.75, 3.0)
