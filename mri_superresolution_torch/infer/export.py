"""Portable serving artifacts through ``torch.export``.

The port's counterpart of the JAX package's ``infer/export.py``. An
artifact is one file holding the serving forward as exported programs with
the weights inside: it loads and serves without the model zoo, the
checkpoint formats or the engine (``load_artifact`` imports ``kernels``,
whose operators the programs call, and nothing of ``models/``, ``train/``
or ``infer/engine.py``). Only the command-line contract is the JAX
package's; the file format is the port's own, and each package refuses
the other's.

Design:
- the batch is symbolic (``torch.export.Dim``): one program serves every
  batch size. It is traced at a batch of 2, and nothing in the forward
  branches on the batch;
- H and W are specialised, one program per (H, W): the unet's
  pad-to-match is Python control flow on concrete sizes, as in JAX;
- the programs hold the ATen operations the eager forward runs and the
  port's kernels as the operators ``torch.ops.mri_sr.*``
  (``kernels/_ops.py``), with no decomposition, so a program gives the
  eager forward's bits on the same device;
- a program is saved on the CPU and moved at load to the device it
  serves on (``torch.export.passes.move_to_device_pass``), so one file
  serves on the card and on the CPU: on the card the operators launch the
  kernels, on the CPU they run the plain versions;
- container: a magic of its own, a JSON header, then per shape the
  length-prefixed ``torch.export.save`` bytes of its program (and, in
  int8 mode, of its fallback). No Python object is pickled by the
  container.
"""

from __future__ import annotations

import io
import json
import os
import struct
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mri_superresolution_torch.infer.transfer import HostTransfers
from mri_superresolution_torch.ops.quant import FOREGROUND_INTENSITY
from mri_superresolution_torch.utils.device import resolve_device

MAGIC = b"MRISRT1\n"
# the JAX package's artifacts (jax.export programs), refused by name
JAX_MAGIC = b"MRISRX1\n"
FORMAT = "mri-sr-torch-serving-artifact-v1"
PLATFORMS = ("cuda", "cpu")
_OUT_DTYPES = ("float32", "int16", "uint8")
_RAW_DTYPES = ("uint8", "uint16", "int16", "float32")
# the batch programs are traced at: a batch of 1 would specialise it
_TRACE_BATCH = 2


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _strides(shape) -> tuple:
    """A C-contiguous tensor's strides for ``shape``."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


class _Program(torch.nn.Module):
    """``fn`` as a module whose parameters are the model's, so that the
    exported program carries them in its state_dict."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, x):
        return self._fn(x)


def _example(shape, raw_dtype: Optional[str], dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    x = torch.rand(shape, generator=g)
    if raw_dtype is not None:
        x = (x * 900.0).to(getattr(torch, raw_dtype))
    return x.to(dev)


def _export_program(model, fn, example: torch.Tensor) -> bytes:
    """``fn`` exported with a symbolic batch, moved to the CPU and
    serialised. ``fn`` runs eagerly once first: it fills the forward's
    caches of device constants (``ops/resize``'s bilinear matrices) with
    real tensors, which tracing then reads as constants instead of
    caching fake ones."""
    from torch.export import Dim
    from torch.export.passes import move_to_device_pass
    prog = _Program(model, fn)
    with torch.inference_mode():
        fn(example)
    with torch.no_grad():
        ep = torch.export.export(
            prog, (example,),
            dynamic_shapes=({0: Dim("batch", min=1)},))
    ep = move_to_device_pass(ep, "cpu")
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_artifact(path: str, state_dict: Dict[str, torch.Tensor],
                    model_cfg, shapes: Sequence[Tuple[int, int]],
                    bf16: bool = True,
                    platforms: Sequence[str] = PLATFORMS,
                    mode: str = "plain", quant_scales=None,
                    min_foreground: float = 0.05, serve_raw: bool = False,
                    raw_dtype: str = "int16", out_dtype: str = "float32",
                    spatial_shards: int = 1) -> None:
    """Export the clipped serving forward at each (H, W) of ``shapes``
    (the batch symbolic) and write the artifact to ``path``. The programs
    are traced on the device ``state_dict`` lies on.

    ``mode``:
    - "plain": the bf16 (fp32 without ``bf16``) clipped forward;
    - "tta": the whole dihedral ensemble (``ops/tta.py``: 8 members for a
      square shape, 4 otherwise) as one program, each member zero-padded
      to a multiple of 8 after its transform inside the program, so the
      shape need not be %8; any packing applies to the fp32 mean;
    - "int8": the frozen-scale int8 forward (``quant_scales``, a
      ``{site: (Cin,)}`` dict as ``quant_forward.load_scales`` reads a
      sidecar) with its int8 weights inside, plus the plain forward as a
      fallback program per shape: the loader serves a batch with less
      than ``min_foreground`` of its pixels above
      ``ops/quant.FOREGROUND_INTENSITY`` on the fallback, the engine's
      routing.

    ``out_dtype`` "int16"/"uint8" packs the outputs on the device
    (``ops/functional.pack_unit``); refused with "int8", whose pair of
    programs stays float32. ``serve_raw`` ("plain" only): the programs
    take raw ``raw_dtype`` batches in the transposed (N, w, h) layout of
    a NIfTI volume's buffer, run the percentile window and min-max
    normalize on the device and return (N, 2w, 2h), the engine's
    ``normalize_inputs`` with ``transpose_io``. ``platforms`` names the
    devices the artifact promises to serve on ("cuda", "cpu").
    ``spatial_shards`` > 1 is not ported (ROADMAP A14).
    """
    if mode not in ("plain", "tta", "int8"):
        raise ValueError(f"unknown artifact mode {mode!r}")
    out_dt = np.dtype(out_dtype)
    if out_dt.name not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32/int16/uint8, "
                         f"got {out_dtype}")
    if mode == "int8" and out_dt != np.dtype(np.float32):
        raise ValueError("out_dtype packing does not compose with "
                         "mode='int8' artifacts (the routed int8+fallback "
                         "pair stays float32); use a checkpoint engine "
                         "for packed int8 serving")
    if serve_raw and mode != "plain":
        raise ValueError("serve_raw composes with mode='plain' only "
                         "(the tta ensemble's transforms and the int8 "
                         "host-side routing both read the standard "
                         "normalized layout)")
    in_dt = np.dtype(raw_dtype)
    if serve_raw and in_dt.name not in _RAW_DTYPES:
        raise ValueError(f"raw_dtype must be uint8/uint16/int16/float32, "
                         f"got {raw_dtype}")
    if int(spatial_shards) != 1:
        raise NotImplementedError(
            "spatial (row-sharded) artifacts are not ported yet "
            "(ROADMAP A14)")
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{list(platforms)}")
    if mode == "int8" and quant_scales is None:
        raise ValueError("mode='int8' requires quant_scales (load a "
                         "QAT sidecar with quant_forward.load_scales)")
    if mode != "tta":
        for h, w in shapes:
            if h % 8 or w % 8:
                raise ValueError(
                    f"artifact shapes must be %8 (got {h}x{w}); the "
                    "engine's bucket padding is a host-side concern the "
                    "artifact does not carry (the loader's pad=True "
                    "applies it; tta-mode artifacts pad internally)")

    from mri_superresolution_torch.models import build_model, quant_forward
    from mri_superresolution_torch.ops.functional import pack_unit
    from mri_superresolution_torch.ops.normalize import normalize_slices
    from mri_superresolution_torch.ops.tta import tta_ensemble

    dev = next(iter(state_dict.values())).device
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = build_model(model_cfg, dtype=dtype)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(dev).eval().requires_grad_(False)

    def clipped(fwd):
        # the engine's order: forward, clamp, the channel dropped
        return lambda x: fwd(x[..., None]).clamp(0.0, 1.0)[..., 0]

    plain = clipped(model)
    if mode == "int8":
        int8_fn = quant_forward.build_int8_forward(
            model.state_dict(), quant_scales, model_cfg.model_type, dtype)
        params = model.state_dict()
        core = clipped(lambda x: int8_fn(params, x))
    elif mode == "tta":
        def core(x):
            def member(a):
                return model(a).clamp(0.0, 1.0)
            return tta_ensemble(member, x[..., None],
                                lambda h, w: (_pad8(h), _pad8(w)))[..., 0]
    else:
        core = plain
    if serve_raw:
        def fn(x):
            xn = normalize_slices(x.float().transpose(1, 2))
            return pack_unit(core(xn).transpose(1, 2), out_dt)
    else:
        def fn(x):
            return pack_unit(core(x), out_dt)

    blobs = []
    for h, w in shapes:
        if serve_raw:
            example = _example((_TRACE_BATCH, w, h), in_dt.name, dev)
        else:
            example = _example((_TRACE_BATCH, h, w), None, dev)
        blobs.append(_export_program(model, fn, example))
        if mode == "int8":
            blobs.append(_export_program(model, plain, example))

    header = {
        "format": FORMAT,
        "model_type": model_cfg.model_type,
        "base_filters": model_cfg.base_filters,
        "bf16": bool(bf16),
        "scale": 2,
        "mode": mode,
        "platforms": list(platforms),
        "shapes": [[int(h), int(w)] for h, w in shapes],
        # per shape: the int8 program, then its plain fallback
        "routed": mode == "int8",
        "min_foreground": float(min_foreground),
        "serve_raw": bool(serve_raw),
        "raw_dtype": in_dt.name if serve_raw else None,
        "out_dtype": out_dt.name,
        "torch_version": torch.__version__,
    }
    hdr = json.dumps(header, sort_keys=True).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for blob in blobs:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
    os.replace(tmp, path)


class ServingArtifact(HostTransfers):
    """A loaded artifact: a program per exported (H, W), batch symbolic,
    on one device.

    ``upscale_batch`` keeps the engine's contract ((N, h, w) float [0, 1]
    -> (N, 2h, 2w)) at the exported shapes. The attributes the serving
    daemon reads are named as the engine's (``normalize_inputs``,
    ``transpose_io``, ``out_dtype``), so a raw artifact serves the
    daemon's volume endpoint as a raw engine does. On the card uploads
    and fetches are the engine's (``infer/transfer.py``)."""

    def __init__(self, header: Dict, programs: Dict[Tuple[int, int], object],
                 fallbacks: Dict[Tuple[int, int], object], device):
        self.header = header
        self.device = device
        self.model_type = header["model_type"]
        self.mode = header["mode"]
        self.routed = bool(header["routed"])
        self.min_foreground = float(header["min_foreground"])
        self.normalize_inputs = bool(header["serve_raw"])
        self.transpose_io = self.normalize_inputs
        self.raw_dtype = (np.dtype(header["raw_dtype"])
                          if self.normalize_inputs else None)
        self.out_dtype = np.dtype(header["out_dtype"])
        self._programs = programs
        self._fallbacks = fallbacks
        self._d2h = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)

    @property
    def shapes(self):
        return sorted(self._programs)

    def _pick(self, key: Tuple[int, int], batch: np.ndarray):
        """The program for ``key``; an int8 artifact serves a batch whose
        real pixels are less than ``min_foreground`` foreground on its
        plain fallback (the engine's guardrail: int8's noise dominates a
        near-empty slice's small error)."""
        if self._fallbacks and (np.abs(batch) > FOREGROUND_INTENSITY
                                ).mean() < self.min_foreground:
            return self._fallbacks[key]
        return self._programs[key]

    def _run(self, program, arr: np.ndarray) -> torch.Tensor:
        """``program`` on the batch ``arr``, uploaded with a contiguous
        tensor's own strides: a program keeps the layout decisions its
        trace made, and a size-1 dimension's stride (0 in a numpy
        ``x[None]``) may steer an operation's output layout elsewhere."""
        with torch.inference_mode():
            x = self._upload(arr)
            return program(x.as_strided(x.shape, _strides(x.shape)))

    def _dispatch(self, batch: np.ndarray, pad: bool) -> torch.Tensor:
        """One batch through its program, queued on the device; the
        output cropped on the device, nothing fetched."""
        if self.normalize_inputs:
            # the raw transposed contract: (n, w, h) stored values in,
            # (n, 2w, 2h) out
            _, wt, ht = batch.shape
            if pad and (ht, wt) not in self._programs:
                raise ValueError(
                    "serve_raw artifacts cannot serve unexported shapes "
                    "by padding (zero pads would dilute the device-side "
                    "percentile normalize); re-export with shape "
                    f"{ht}x{wt} included")
            if batch.dtype == np.float64 and \
                    self.raw_dtype == np.dtype(np.float32):
                batch = batch.astype(np.float32)
            if batch.dtype != self.raw_dtype:
                raise ValueError(
                    f"this raw artifact was exported for {self.raw_dtype} "
                    f"inputs, got {batch.dtype} (re-export with "
                    "--raw_dtype or convert on the host)")
            if (ht, wt) not in self._programs:
                raise ValueError(
                    f"artifact has no program for {ht}x{wt}; exported "
                    f"shapes: {self.shapes}")
            return self._run(self._programs[(ht, wt)], batch)
        n, h, w = batch.shape
        if (h, w) in self._programs:
            return self._run(self._pick((h, w), batch),
                             np.asarray(batch, np.float32))
        if not pad:
            raise ValueError(
                f"artifact has no program for {h}x{w}; exported shapes: "
                f"{self.shapes} (re-export with this shape included)")
        if self.mode == "tta":
            raise ValueError(
                f"tta-mode artifact cannot serve {h}x{w} by padding (the "
                "exported ensemble would transform the zero margin); "
                "re-export with this exact shape included")
        fits = [s for s in self._programs if s[0] >= h and s[1] >= w]
        if not fits:
            raise ValueError(
                f"no exported shape fits {h}x{w}; exported shapes: "
                f"{self.shapes} (re-export with a larger shape)")
        ph, pw = min(fits, key=lambda s: s[0] * s[1])
        # routing reads the real pixels, before the pad (the engine's)
        program = self._pick((ph, pw), batch)
        padded = np.zeros((n, ph, pw), np.float32)
        padded[:, :h, :w] = batch
        return self._run(program, padded)[:, :2 * h, :2 * w]

    def upscale_batch(self, batch: np.ndarray,
                      pad: bool = False) -> np.ndarray:
        """(N, h, w) float [0, 1] -> (N, 2h, 2w) in ``out_dtype``; a raw
        artifact takes (N, w, h) stored values and returns (N, 2w, 2h).

        With ``pad`` a shape with no program of its own is zero-padded to
        the smallest exported shape that fits and the output cropped: the
        engine's bucket padding, with its caveat (a pad moves every
        GroupNorm's whole-image statistics). Refused for tta artifacts,
        whose ensemble would transform the padded array, and for raw
        ones."""
        return self._collect(self._start_fetch(self._dispatch(batch, pad)))

    def upscale_batches(self, batches, pad: bool = False, depth: int = 2):
        """Yields ``map(upscale_batch)`` over ``batches``, with up to
        ``depth`` batches dispatched before the oldest is fetched: the
        engine's window (uploads from page-locked memory, each result
        fetched on a side stream beside the next forward)."""
        depth = max(1, int(depth))
        window: deque = deque()
        for batch in batches:
            window.append(self._start_fetch(self._dispatch(batch, pad)))
            if len(window) > depth:
                yield self._collect(window.popleft())
        while window:
            yield self._collect(window.popleft())

    def upscale_image(self, image01: np.ndarray) -> np.ndarray:
        return self.upscale_batch(image01[None])[0]

    def process_single_image(self, *args, **kwargs):
        """The engine's single-image pipeline (normalize, upscale,
        histogram matching, metrics with SSIM on kernel B2, PNG and
        figures) on this artifact's forward. The engine module is
        imported here, on first use: loading and serving never import
        it."""
        if self.normalize_inputs:
            raise ValueError(
                "serve_raw artifacts take the raw transposed volume "
                "contract; the PNG single-image pipeline needs a standard "
                "artifact (export without --serve_raw)")
        if self.out_dtype != np.dtype(np.float32):
            raise ValueError(
                f"this artifact packs outputs as {self.out_dtype} "
                "(integer codes, not [0,1] floats); the PNG single-image "
                "pipeline (histogram matching, metrics, *255 write) needs "
                "a float32 artifact: export without --out_dtype, or "
                "serve volumes (infer_volume and the daemon decode the "
                "codes through scl_slope)")
        from mri_superresolution_torch.infer.engine import InferenceEngine
        self.calculate_metrics = InferenceEngine.calculate_metrics
        self._save_figures = InferenceEngine._save_figures
        return InferenceEngine.process_single_image(self, *args, **kwargs)


def load_artifact(path: str, device=None) -> ServingArtifact:
    """Read an artifact onto ``device`` (the card unless the caller asks
    for the CPU). Imports ``kernels`` for the operators the programs call,
    and nothing of the model zoo, the trainer or the engine."""
    from torch.export.passes import move_to_device_pass

    from mri_superresolution_torch import kernels  # noqa: F401 (operators)

    dev = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path} is a serving artifact of the JAX package "
                "(mri_superresolution_tpu, tools/export_serving.py: "
                "jax.export programs); export one for this package with "
                "python -m mri_superresolution_torch.cli.export_serving")
        if magic != MAGIC:
            raise ValueError(f"{path} is not a serving artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        if header.get("format") != FORMAT:
            raise ValueError(f"unknown artifact format in {path}")
        if dev.type not in header["platforms"]:
            raise ValueError(
                f"{path} was exported for {header['platforms']}, not "
                f"{dev.type}")

        def program():
            (blen,) = struct.unpack("<Q", f.read(8))
            ep = torch.export.load(io.BytesIO(f.read(blen)))
            return move_to_device_pass(ep, dev).module()

        programs, fallbacks = {}, {}
        for h, w in header["shapes"]:
            programs[(h, w)] = program()
            if header["routed"]:
                fallbacks[(h, w)] = program()
    return ServingArtifact(header, programs, fallbacks, dev)
