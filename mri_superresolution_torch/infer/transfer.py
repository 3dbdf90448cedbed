"""Host-device transfers of a serving backend.

:class:`HostTransfers` is what ``InferenceEngine`` (``infer/engine.py``)
and ``ServingArtifact`` (``infer/export.py``) share to move batches: on
the card, uploads from page-locked memory (the caller's, or a staged
copy) and results fetched on a side stream while the compute stream runs
on. A subclass sets ``device`` and ``_d2h`` (the side stream, None on the
CPU). A backend that spans several devices passes the device's own
holder of those two attributes (``rep``) to :meth:`_upload` and
:meth:`_start_fetch`, so that each device has its own side stream and
staging, and sets ``_register_flags`` to page-lock for every device.
While a profiler runs, each step is a span (``utils/spans.py``):
``engine.upload``, ``engine.page_lock``, ``engine.unlock``,
``engine.fetch`` and ``engine.collect``. No model code is imported here.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from mri_superresolution_torch.utils.spans import span


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor over the C-contiguous host array ``arr``, no copy. A
    backend only reads its inputs, so a read-only buffer (a volume straight
    from ``nifti.load``) is taken as it is."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.from_numpy(arr)


class HostTransfers:
    """Uploads, page-locking and side-stream fetches for a backend whose
    ``device`` and ``_d2h`` stream are set."""

    device: torch.device
    _d2h = None
    # cudaHostRegister flags: 1 (cudaHostRegisterPortable) when the
    # uploads go to more than one device
    _register_flags = 0

    def _upload(self, arr: np.ndarray, rep=None) -> torch.Tensor:
        """The host array on the backend's device, in its own dtype. On the
        card the copy is asynchronous from page-locked memory: straight
        from the caller's buffer when it is page-locked (see
        :meth:`page_locked`), so the caller must leave it unchanged until
        the batch's result is returned; otherwise through a page-locked
        copy (:meth:`_staged`). A copy from pageable memory may wait for
        the compute stream, which would hold the host back while the
        previous batch runs. ``rep`` names the device (default: this
        backend's)."""
        rep = self if rep is None else rep
        with span("engine.upload"):
            src = _host_tensor(np.ascontiguousarray(arr))
            if rep._d2h is None:
                return src
            if not src.is_pinned():
                src = self._staged(src)
            return src.to(rep.device, non_blocking=True)

    @staticmethod
    def _staged(src: torch.Tensor) -> torch.Tensor:
        """A page-locked host copy of ``src``."""
        staged = torch.empty_like(src, pin_memory=True)
        staged.copy_(src)
        return staged

    @contextlib.contextmanager
    def page_locked(self, arr: np.ndarray):
        """Page-lock the C-contiguous host array ``arr`` for the duration
        (``cudaHostRegister``), so that batches that are views of it upload
        from it with no host copy. A volume served in batches is
        registered once around its ``upscale_batches`` loop. Nothing to do
        on the CPU, or when ``arr`` is page-locked already."""
        src = _host_tensor(arr)
        if self._d2h is None or src.numel() == 0 or src.is_pinned():
            yield arr
            return
        if not arr.flags.c_contiguous:
            raise ValueError("page_locked needs a C-contiguous array")
        cudart = torch.cuda.cudart()
        with span("engine.page_lock"), torch.cuda.device(self.device):
            err = cudart.cudaHostRegister(src.data_ptr(), arr.nbytes,
                                          self._register_flags)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {arr.nbytes} bytes "
                               f"failed: cudaError {int(err)}")
        try:
            yield arr
        finally:
            with span("engine.unlock"):
                # the uploads from ``arr`` are done before it is unlocked
                for dev in {r.device for r in getattr(self, "_replicas",
                                                      [self])}:
                    torch.cuda.synchronize(dev)
                with torch.cuda.device(self.device):
                    err = cudart.cudaHostUnregister(src.data_ptr())
            if int(err) != 0:
                raise RuntimeError(f"cudaHostUnregister failed: cudaError "
                                   f"{int(err)}")

    def _start_fetch(self, y: torch.Tensor, rep=None):
        """Queue the copy of the device result ``y`` to the host; returns a
        handle for :meth:`_collect`. On the card, ``y`` is made contiguous
        on the compute stream, and the copy into a fresh page-locked buffer
        runs on the side stream once an event recorded after it has fired,
        so the compute stream goes on with the next batch meanwhile. The
        buffer comes from PyTorch's caching host allocator, which does not
        hand it out again before the copy's event has fired and the
        returned array is gone. ``rep`` names ``y``'s device (default:
        this backend's)."""
        rep = self if rep is None else rep
        with span("engine.fetch"), torch.inference_mode():
            y = y.contiguous()
            if rep._d2h is None:
                return y, None
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(rep.device))
            out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            with torch.cuda.stream(rep._d2h):
                rep._d2h.wait_event(ready)
                out.copy_(y, non_blocking=True)
                # y's memory stays with y until the side stream is done
                y.record_stream(rep._d2h)
                done = torch.cuda.Event()
                done.record(rep._d2h)
        return out, done

    @staticmethod
    def _collect(handle) -> np.ndarray:
        """Wait for a fetch queued by :meth:`_start_fetch` and return the
        host array, the sole view of its buffer."""
        out, done = handle
        with span("engine.collect"):
            if done is not None:
                done.synchronize()
            return out.numpy()
