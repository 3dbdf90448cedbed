"""Batched, shape-bucketed inference engine on one GPU or several.

Reference behaviour reproduced (scripts/infer.py): percentile-clip
[0.5, 99.5] + min-max normalize of inputs (:97-130), outputs clamped to
[0, 1] (:276), optional histogram matching against a normalized target
(:278-314), metrics with a bicubic target resize on shape mismatch
(:317-324), PNG and comparison/diff figure outputs (:173-228, 336-394).

Each batch is uploaded as it is, zero-padded to the shape bucket on the
card, run through the bf16 (or fp32) model of any family
(``models/families.py``), clamped, cropped to exactly 2x the input and,
for uint8/int16 ``out_dtype``, packed on the card before the fetch. The
engine runs on the card unless ``device="cpu"`` is passed. The serving
options are the JAX engine's (``infer/engine.py`` there):

- ``normalize_inputs``: raw uint8/uint16/int16/float batches are
  normalized per slice on the card (``ops/normalize.py``), before the
  bucket pad, so the percentiles see only real pixels;
- ``transpose_io``: batches arrive (N, w, h), the free C-order view of a
  NIfTI volume's F-order buffer, and return C-contiguous (N, 2w, 2h), so
  that ``.T`` of the result is the F-order output volume; both swaps run
  on the card;
- ``tta``: the dihedral ensemble (``ops/tta.py``), one upload, the
  members accumulated in fp32 on the card, one fetch; for bf16, fp32 and
  frozen-int8 batches. Only int8 that is still calibrating runs the
  members one by one through the single-forward path, where the identity
  pass alone feeds calibration;
- ``upscale_batches``: ``map(upscale_batch)`` with up to ``depth``
  batches dispatched before the oldest is fetched; on the card each
  result crosses to the host on a side stream, beside the next forward;
- ``page_locked``: a volume registered once, so that its batches upload
  from its own buffer with no host copy;
- ``upscale_tiled``: halo-overlapped tiles for slices too large for one
  forward;
- ``num_devices`` / ``devices``: a copy of the params on each device of
  the pool (``parallel.device_pool``: the first ``num_devices`` visible
  GPUs, 0 = all, as the JAX engine's ``make_mesh`` caps; or every device
  of ``devices``, the counterpart of ``make_mesh(devices=...)``, which may
  name one card twice, or the CPU), each batch zero-padded to a multiple
  of the device count and split in equal chunks, each chunk uploaded to,
  run on and fetched from its device (its own staging and side stream),
  all enqueued from the calling thread before any is waited for, and the
  results gathered in order: the JAX engine's data-sharded forward in one
  process. The TTA,
  frozen and streaming int8 modes compose with it as in JAX (the
  calibration max taken over every device's chunk, padding rows
  included, as JAX's sharded calibration forward takes it);
- ``spatial_shards`` > 1: the pool is a (len(pool) / shards, shards)
  grid (``parallel/spatial.py``), the JAX engine's (data, space) mesh.
  Each data group's chunk is uploaded to its first device, its rows are
  split over the group's devices for the row-sharded forward (halo rows
  and GroupNorm sums exchanged between them), and the output rows are
  gathered back there. Without ``devices`` the pool is ``num_devices``
  slots (0: one a visible GPU) over the GPUs in turn, so one card may
  hold every shard. Batches are zero-padded to H % (8 * shards) == 0
  and W % 8 == 0, with a warning, as that moves every GroupNorm's
  statistics. bf16, fp32, TTA, frozen int8 (the folded int8 weights made
  once) and streaming calibration run on the row-sharded forwards.

``quant="int8"`` serves the int8 post-training-quantized model
(``models/quant_forward.py``) with the JAX engine's state machine
(``infer/engine.py:371-467`` there): streaming self-calibration on
content-rich batches, then frozen scales (saved to ``quant_calib_path`` if
given, or loaded from it), and near-empty batches on the bf16 model.
"""

from __future__ import annotations

import contextlib
import logging
import os
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mri_superresolution_torch.config import (InferConfig, ModelConfig,
                                              model_config_from_dict)
from mri_superresolution_torch.infer.transfer import HostTransfers
from mri_superresolution_torch.kernels import ssim_per_sample
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.models.families import with_weight_widths
from mri_superresolution_torch.ops.functional import pack_unit
from mri_superresolution_torch.ops.metrics import mae, match_histograms_np, mse
from mri_superresolution_torch.ops.normalize import normalize_slices
from mri_superresolution_torch.ops.quant import FOREGROUND_INTENSITY
from mri_superresolution_torch.ops.resize import Interp, resize
from mri_superresolution_torch.ops.tta import dihedral_pairs, tta_ensemble
from mri_superresolution_torch.parallel.mesh import (device_pool,
                                                     pad_batch_to_devices)
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.spans import span

logger = logging.getLogger("mri_superresolution_torch.infer")

_OUT_DTYPES = (np.dtype(np.float32), np.dtype(np.uint8), np.dtype(np.int16))


def preprocess_image_array(image: np.ndarray,
                           min_percentile: float = 0.5,
                           max_percentile: float = 99.5) -> np.ndarray:
    """Percentile clip + min-max normalize to [0,1]
    (parity: scripts/infer.py:97-130)."""
    x = image.astype(np.float32)
    lo = np.percentile(x, min_percentile)
    hi = np.percentile(x, max_percentile)
    x = np.clip(x, lo, hi)
    if hi > lo:
        x = (x - lo) / (hi - lo)
    return x


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class _Replica:
    """A model copy on one further device of an engine's pool, with the
    attributes the engine keeps for its first device: ``device``,
    ``model``, ``_params``, ``_d2h`` and ``_quant_fwd``."""

    def __init__(self, device: torch.device, model: torch.nn.Module):
        self.device = device
        self.model = model
        self._params = model.state_dict()
        self._d2h = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)
        self._quant_fwd = None


def _spatial_pool(num_devices: int, device) -> list:
    """A row-sharded engine's device slots: ``num_devices`` of them (0:
    one a visible GPU), over the visible GPUs in turn, so that a card is
    named more than once when the slots outnumber the cards; on the CPU,
    when it is asked for, that many CPU devices (0: one)."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * max(1, num_devices)
    cards = device_pool(0)
    n = num_devices if num_devices > 0 else len(cards)
    return [cards[i % len(cards)] for i in range(n)]


def _on(rep):
    """The CUDA device context of ``rep`` (nothing on the CPU), so that
    the kernels' launches find their device."""
    if rep.device.type == "cuda":
        return torch.cuda.device(rep.device)
    return contextlib.nullcontext()


class InferenceEngine(HostTransfers):
    """Holds a model with its params on each device of its pool and serves
    padded, bucketed forwards."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 bf16: bool = True, bucket: int = 1, out_dtype=None,
                 device=None, tta: bool = False, quant: str = "none",
                 quant_calib_slices: int = 8,
                 quant_min_foreground: float = 0.05,
                 quant_calib_path: Optional[str] = None,
                 spatial_shards: int = 1, normalize_inputs: bool = False,
                 transpose_io: bool = False, num_devices: int = 1,
                 devices=None):
        if transpose_io and not normalize_inputs:
            raise ValueError("transpose_io requires normalize_inputs (the "
                             "card-side input path does the swap)")
        if normalize_inputs and quant == "int8":
            raise ValueError(
                "normalize_inputs is incompatible with --quant int8: the "
                "engine's content-aware routing reads normalized [0,1] "
                "pixels on the host; normalize on the host for int8 "
                "serving")
        if transpose_io and tta:
            raise ValueError(
                "transpose_io does not compose with tta (the ensemble's "
                "transforms are defined on (N, h, w) batches); serve TTA "
                "volumes through the standard layout")
        if spatial_shards < 1:
            raise ValueError("spatial_shards must be >= 1")
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        if quant == "int8":
            if not quant_forward.supported(model_cfg.model_type):
                raise ValueError(
                    f"--quant int8 supports model types "
                    f"{quant_forward.supported_types()}, not "
                    f"{model_cfg.model_type!r}")
            if quant_calib_slices < 1:
                raise ValueError("quant_calib_slices must be >= 1")
            if model_cfg.model_type == "unet_tpu":
                logger.warning(
                    "--quant int8 on model type 'unet_tpu': its final stage "
                    "runs at the input resolution, where the quantize "
                    "passes may outweigh the int8 convs' gain; compare its "
                    "slices/s against bf16 on your card before choosing "
                    "(chip_smoke.py's zoo phase measures both)")
        self.model_cfg = model_cfg
        self.spatial_shards = int(spatial_shards)
        # the device pool: ``devices`` as given, else the grid's slots
        # (spatial), else the CPU when it is asked for, else num_devices
        # GPUs (1: ``device``, the card)
        if devices is not None:
            pool = device_pool(0, devices)
        elif self.spatial_shards > 1:
            pool = _spatial_pool(num_devices, device)
        elif num_devices == 1 or (device is not None
                                  and torch.device(device).type == "cpu"):
            pool = [resolve_device(device)]
        else:
            pool = device_pool(num_devices)
        self.device = pool[0]
        self.n_devices = len(pool)
        self.out_dtype = np.dtype(out_dtype if out_dtype is not None
                                  else np.float32)
        if self.out_dtype not in _OUT_DTYPES:
            raise ValueError(f"out_dtype must be float32/uint8/int16, got "
                             f"{self.out_dtype}")
        self.tta = tta
        self.normalize_inputs = bool(normalize_inputs)
        self.transpose_io = bool(transpose_io)
        self._dtype = torch.bfloat16 if bf16 else torch.float32
        self.model = build_model(model_cfg, dtype=self._dtype)
        self.model.load_state_dict(params, strict=True)
        self.model.to(self.device).eval()
        self._sp_mesh = None
        if self.spatial_shards > 1:
            self._sp_mesh = self._spatial_mesh(pool)
        self.bucket = bucket
        # results cross to the host on this stream, beside the next forward
        self._d2h = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)
        # one holder a device of the pool, this engine the first
        self._replicas = [self]
        for dev in pool[1:]:
            m = build_model(model_cfg, dtype=self._dtype)
            m.load_state_dict(params, strict=True)
            self._replicas.append(_Replica(dev, m.to(dev).eval()))
        # the devices a batch's chunks go to: each device, or the first
        # device of each spatial data group
        self._leads = self._replicas[::self.spatial_shards]
        if len(pool) > 1:
            self._register_flags = 1          # cudaHostRegisterPortable
        if self._sp_mesh is not None:
            logger.info(
                f"Spatially-sharded serving: ({self.n_devices} data x "
                f"{self.spatial_shards} space) grid over "
                f"{[str(d) for d in pool]}: each batch padded to a multiple "
                f"of {self.n_devices} and split, each slice's rows split "
                f"{self.spatial_shards} ways")
        elif self.n_devices > 1:
            logger.info(f"Serving on {self.n_devices} devices: "
                        f"{[str(d) for d in pool]} (each batch padded to a "
                        f"multiple of {self.n_devices} and split)")

        self.quant = quant
        self.quant_calib_path = quant_calib_path
        self.quant_calib_slices = quant_calib_slices
        self.quant_min_foreground = quant_min_foreground
        # views of the model's params, for the functional forwards
        self._params = self.model.state_dict()
        self._quant_scales = None    # frozen per-site scales; None while
        #                              calibrating
        self._quant_fwd = None       # int8 forward, built on freeze (one a
        #                              device, on each replica)
        self._calib_amax: Dict[str, np.ndarray] = {}
        self._calib_seen = 0         # real (unpadded) slices calibrated on
        self._quant_batches = {"int8": 0, "bf16": 0}
        self._sp_fns: dict = {}      # (kind, group, bh, bw) -> forward
        self._sp_qweights = None     # folded int8 weights (spatial)
        self._warned: set = set()    # shapes whose padding was warned of
        if (quant == "int8" and quant_calib_path
                and os.path.exists(quant_calib_path)):
            # deterministic serving: reuse frozen scales instead of
            # re-calibrating on whatever data arrives first
            scales, saved_type = quant_forward.load_scales(quant_calib_path)
            if saved_type != model_cfg.model_type:
                raise ValueError(
                    f"{quant_calib_path} holds scales for model type "
                    f"{saved_type!r}, not {model_cfg.model_type!r}")
            self._build_int8(scales)
            logger.info(f"int8 PTQ: loaded {len(scales)} frozen activation "
                        f"scales from {quant_calib_path}; serving int8 from "
                        "the first batch")

    def _spatial_mesh(self, pool):
        """The (len(pool) // spatial_shards, spatial_shards) grid of the
        row-sharded forwards (``parallel/spatial.py``); the data groups
        are the batch axis."""
        from mri_superresolution_torch.parallel import spatial
        if self.model_cfg.model_type not in spatial.supported_types():
            raise ValueError(
                f"spatial_shards > 1 supports the "
                f"{spatial.supported_types()} topologies, not "
                f"{self.model_cfg.model_type!r}")
        if len(pool) % self.spatial_shards:
            raise ValueError(f"spatial_shards={self.spatial_shards} must "
                             f"divide the {len(pool)} mesh devices")
        self.n_devices = len(pool) // self.spatial_shards
        return spatial.make_spatial_mesh(self.n_devices, self.spatial_shards,
                                         pool)

    def _spatial_fn(self, kind: str, g: int, bh: int, bw: int):
        """Data group ``g``'s row-sharded forward of ``kind`` ("plain",
        "int8" or "calib") at (bh, bw), built once."""
        from mri_superresolution_torch.parallel import spatial
        key = (kind, g, bh, bw)
        if key not in self._sp_fns:
            row, mt = self._sp_mesh.row(g), self.model_cfg.model_type
            if kind == "plain":
                fn = spatial.build_spatial_forward_raw(row, (bh, bw),
                                                       self._dtype, mt)
            elif kind == "int8":
                fn = spatial.build_spatial_int8_forward_raw(
                    row, (bh, bw), self._params, self._quant_scales, mt,
                    self._dtype, qweights=self._sp_qweights)
            else:
                fn = spatial.build_spatial_calib_forward_raw(
                    row, (bh, bw), quant_forward.amax_template(
                        self._params, mt), mt, self._dtype)
            self._sp_fns[key] = fn
        return self._sp_fns[key]

    def _group_params(self, g: int) -> list:
        s = self.spatial_shards
        return [r._params for r in self._replicas[g * s:(g + 1) * s]]

    def _run(self, kind: str, g: int, x: torch.Tensor):
        """Data group ``g``'s forward of ``kind`` on its chunk ``x``: the
        model ("plain"), the frozen int8 forward or the calibration
        forward (-> (y, amax)); row-sharded over the group's devices
        when ``spatial_shards`` > 1, else on the group's one device."""
        r = self._leads[g]
        with span("engine.forward", r.device, count=x.shape[0]):
            if self._sp_mesh is not None:
                fn = self._spatial_fn(kind, g, x.shape[1], x.shape[2])
                return fn(self._group_params(g), x)
            with _on(r):
                if kind == "plain":
                    return r.model(x)
                if kind == "int8":
                    return r._quant_fwd(r._params, x)
                return quant_forward.build_calib_forward(
                    self.model_cfg.model_type, dtype=self._dtype)(r._params,
                                                                  x)

    def _build_int8(self, scales) -> None:
        """Freeze ``scales`` into the int8 forward of each device
        (validates that they cover every site). Row-sharded engines fold
        the int8 weights once here and build a forward per shape
        lazily."""
        if self._sp_mesh is not None:
            self._sp_qweights = quant_forward.int8_qweights(
                self._params, scales, self.model_cfg.model_type)
            self._quant_scales = scales
            return
        for rep in self._replicas:
            rep._quant_fwd = quant_forward.build_int8_forward(
                rep._params, scales, self.model_cfg.model_type,
                dtype=self._dtype)
        self._quant_scales = scales

    def _served(self, mode: str, count: bool) -> None:
        """Count a batch of the int8 path at the precision it is served
        at (unless ``count`` is False)."""
        if count:
            self._quant_batches[mode] += 1

    def _quant_upscale(self, xs: List[torch.Tensor], n_real_slices: int,
                       foreground_frac: float, calib_ok: bool = True,
                       count: bool = True,
                       force_bf16: bool = False) -> List[torch.Tensor]:
        """int8 PTQ serving with streaming self-calibration. Content-rich
        batches run the bf16 calib forward, which records each conv site's
        per-input-channel max |x|, until ``quant_calib_slices`` real slices
        have been seen; then the scales freeze and later batches run int8.
        A batch that completes calibration by itself is re-served int8 (so
        a one-image ``--quant int8`` run gives int8 output).

        ``foreground_frac`` is taken on the real pixels, before zero
        padding. Batches below ``quant_min_foreground`` neither calibrate
        nor run int8: they serve on the bf16 model, where int8 noise would
        dominate their small error.

        For the host TTA loop: ``calib_ok=False`` serves bf16 without
        feeding the statistics while calibrating (8 flips of one slice are
        not 8 calibration slices); ``count=False`` leaves the batch count
        alone (one ensemble counts as one batch); ``force_bf16`` pins the
        bf16 model, so an ensemble whose identity pass was served bf16
        stays bf16 even when that pass froze the scales.

        ``xs`` holds the batch's chunk on each device (each data group's
        first device), and the result is each chunk's output: one
        decision a batch, the calibration's max taken over every chunk."""
        if (force_bf16 or foreground_frac < self.quant_min_foreground
                or (self._quant_scales is None and not calib_ok)):
            self._served("bf16", count)
            return [self._run("plain", g, x) for g, x in enumerate(xs)]
        if self._quant_scales is None:
            first = self._calib_seen == 0
            ys = []
            for g, x in enumerate(xs):
                y, amax = self._run("calib", g, x)
                ys.append(y)
                for k, v in amax.items():
                    v = v.cpu().numpy()
                    self._calib_amax[k] = (np.maximum(self._calib_amax[k], v)
                                           if k in self._calib_amax else v)
            self._calib_seen += max(n_real_slices, 1)
            if self._calib_seen < self.quant_calib_slices:
                logger.info(f"int8 PTQ: calibrating "
                            f"({self._calib_seen}/{self.quant_calib_slices} "
                            "slices seen); serving bf16 meanwhile")
                self._served("bf16", count)
                return ys
            scales = quant_forward.scales_from_amax(self._calib_amax)
            logger.info(f"int8 PTQ: froze {len(scales)} activation scales "
                        f"after {self._calib_seen} calibration slice(s)")
            self._build_int8(scales)
            if self.quant_calib_path:
                quant_forward.save_scales(self.quant_calib_path, scales,
                                          self.model_cfg.model_type)
                logger.info(f"int8 PTQ: saved frozen scales to "
                            f"{self.quant_calib_path}; later runs serve "
                            "int8 from the first batch")
            if not first:
                # this batch has its bf16 result already; int8 starts
                # with the next one
                self._served("bf16", count)
                return ys
        self._served("int8", count)
        return [self._run("int8", g, x) for g, x in enumerate(xs)]

    @property
    def quant_calibrating(self) -> bool:
        """True while int8 self-calibration still counts slices (scales
        not frozen yet)."""
        return self.quant == "int8" and self._quant_scales is None

    def quant_summary(self) -> str:
        """One-line serving account for a CLI to log after a --quant run."""
        c = self._quant_batches
        state = ("scales frozen" if self._quant_scales is not None else
                 f"calibration INCOMPLETE "
                 f"({self._calib_seen}/{self.quant_calib_slices} slices — "
                 "all batches were served bf16; lower --quant_calib_slices "
                 "or serve more data)")
        return (f"int8 PTQ summary: {c['int8']} batch(es) served int8, "
                f"{c['bf16']} bf16 (calibration/near-empty routing); {state}")

    def _bucket_hw(self, h: int, w: int) -> Tuple[int, int]:
        bh = _round_up(max(h, 8), self.bucket)
        bw = _round_up(max(w, 8), self.bucket)
        if self.spatial_shards > 1:
            # the row-sharded forward needs H % (8 * shards) == 0 and
            # W % 8 == 0; like bucket > 1 this gives up GroupNorm
            # exactness at other sizes to keep the pools shard-local
            bh = _round_up(bh, 8 * self.spatial_shards)
            bw = _round_up(bw, 8)
        return bh, bw

    def _warn_padding(self, h: int, w: int, bh: int, bw: int,
                      tta: bool = False) -> None:
        """Warn, once a shape, that the row-sharded path pads an h x w
        batch to (bh, bw), which moves every GroupNorm's statistics."""
        if self.spatial_shards == 1 or (bh, bw) == (h, w) or \
                (tta, h, w) in self._warned:
            return
        self._warned.add((tta, h, w))
        s = self.spatial_shards
        if tta:
            logger.warning(
                f"spatial_shards={s} pads {h}x{w} TTA members to {bh}x{bw}: "
                "whole-image GroupNorm statistics differ from the dense "
                "forward (same caveat as non-TTA spatial serving).")
            return
        pad_frac = 1.0 - (h * w) / (bh * bw)
        logger.warning(
            f"spatial_shards={s} pads {h}x{w} inputs to {bh}x{bw} "
            f"({pad_frac:.1%} zero pixels): whole-image GroupNorm "
            "statistics now differ from the dense forward. Use "
            f"H % {8 * s} == 0, W % 8 == 0 inputs for exact spatial "
            "serving.")

    @staticmethod
    def _foreground(batch: np.ndarray) -> float:
        """Fraction of the batch's real pixels above FOREGROUND_INTENSITY
        (the int8 routing's measure, taken on the host)."""
        return float((np.abs(batch) > FOREGROUND_INTENSITY).mean())

    def _device_input(self, batch: np.ndarray, bh: int, bw: int,
                      rep=None) -> torch.Tensor:
        """The (n, h, w) batch — (n, w, h) under ``transpose_io`` — as the
        forward's (max(n, 1), bh, bw, 1) fp32 input on the device. The raw
        batch is uploaded as it is; then, on the device: cast to fp32,
        swap the axes (``transpose_io``), normalize per slice
        (``normalize_inputs``) and zero-pad to (bh, bw), so that the
        percentiles see only real pixels. Runs under inference mode, on
        ``rep``'s device (default: the first)."""
        if batch.shape[0] == 0:
            batch = np.zeros((1,) + batch.shape[1:], batch.dtype)
        x = self._upload(batch, rep)
        with span("engine.normalize"):
            x = x.float()
            if self.transpose_io:
                x = x.transpose(1, 2)
            if self.normalize_inputs:
                x = normalize_slices(x)
            h, w = x.shape[1:]
            if (bh, bw) != (h, w):
                x = F.pad(x, (0, bw - w, 0, bh - h))
            return x[..., None]

    def _chunks(self, batch: np.ndarray) -> Tuple[list, List[int]]:
        """The batch's chunk for each device and its count of real rows:
        on one device the batch itself; on several the batch zero-padded
        to a multiple of the device count and split in equal chunks, as
        the JAX engine pads to its mesh (``_round_up(n, n_devices)``)."""
        n, nd = batch.shape[0], self.n_devices
        if nd == 1:
            return [batch], [n]
        nb = pad_batch_to_devices(max(n, 1), nd)
        if nb != n:
            padded = np.zeros((nb,) + batch.shape[1:], batch.dtype)
            padded[:n] = batch
            batch = padded
        c = nb // nd
        return ([batch[i * c:(i + 1) * c] for i in range(nd)],
                [max(0, min(c, n - i * c)) for i in range(nd)])

    def _dispatch_once(self, batch: np.ndarray,
                       _quant_calib_ok: bool = True,
                       _quant_count: bool = True,
                       _quant_force_bf16: bool = False,
                       _pack: bool = True) -> List[torch.Tensor]:
        """Upload -> (normalize) -> pad -> forward -> clip -> crop ->
        (transpose) -> pack, queued on each device for its chunk (every
        chunk uploaded before any forward); nothing is fetched. Returns
        each device's result, the real rows of its chunk. The
        ``_quant_*`` arguments are :meth:`_quant_upscale`'s, for the host
        TTA loop, which also fetches its members unpacked."""
        n = batch.shape[0]
        h, w = ((batch.shape[2], batch.shape[1]) if self.transpose_io
                else (batch.shape[1], batch.shape[2]))
        bh, bw = self._bucket_hw(h, w)
        self._warn_padding(h, w, bh, bw)
        chunks, reals = self._chunks(batch)
        with torch.inference_mode():
            xs = [self._device_input(c, bh, bw, r)
                  for c, r in zip(chunks, self._leads)]
            if self.quant == "int8":
                ys = self._quant_upscale(
                    xs, n, self._foreground(batch), calib_ok=_quant_calib_ok,
                    count=_quant_count, force_bf16=_quant_force_bf16)
            else:
                ys = [self._run("plain", g, x) for g, x in enumerate(xs)]
            with span("engine.pack"):
                out = []
                for y, k in zip(ys, reals):
                    y = y.clamp(0.0, 1.0)[:k, :2 * h, :2 * w, 0]
                    if self.transpose_io:
                        # (N, 2w, 2h): .T of the fetched batch is the
                        # F-order output volume
                        y = y.transpose(1, 2)
                    out.append(pack_unit(y, self.out_dtype) if _pack else y)
                return out

    def _tta_on_device(self) -> bool:
        """True when a --tta batch runs as one card-resident ensemble: bf16
        and fp32 always, int8 once its scales are frozen. Still-calibrating
        int8 runs the host loop (its routing state machine lives on the
        host); the switch goes host -> device once, never back."""
        return self.quant != "int8" or self._quant_scales is not None

    def _tta_dispatch(self, batch: np.ndarray) -> List[torch.Tensor]:
        """The dihedral ensemble on the card (``ops/tta.py``): one upload,
        normalized once if ``normalize_inputs`` (the percentiles and the
        min/max do not change under a dihedral transform), each member
        padded to the bucket after its transform and cropped before its
        inverse, the members summed in fp32, the mean packed. Frozen int8
        takes one routing decision a batch (the transforms keep the
        foreground fraction), counted as one batch. Each device runs the
        ensemble on its chunk."""
        mode = "bf16"
        if self.quant == "int8":
            if self._foreground(batch) >= self.quant_min_foreground:
                mode = "int8"
            self._served(mode, count=True)

        kind = "int8" if mode == "int8" else "plain"
        h, w = batch.shape[1:]
        self._warn_padding(h, w, *self._bucket_hw(h, w), tta=True)
        chunks, reals = self._chunks(batch)
        out = []
        with torch.inference_mode():
            xs = [self._device_input(c, h, w, r)
                  for c, r in zip(chunks, self._leads)]
            for g, (r, x, k) in enumerate(zip(self._leads, xs, reals)):
                with _on(r):
                    y = tta_ensemble(
                        lambda a, g=g: self._run(kind, g, a).clamp(0.0, 1.0),
                        x, self._bucket_hw)
                with span("engine.pack"):
                    out.append(pack_unit(y[:k, :, :, 0], self.out_dtype))
        return out

    def _tta_host_loop(self, batch: np.ndarray) -> np.ndarray:
        """The ensemble member by member through :meth:`_dispatch_once`,
        while int8 still calibrates: the identity pass alone feeds the
        statistics and counts as the batch, and the other members follow
        the precision it was served at, so one ensemble never mixes bf16
        and int8. The members' fp32 outputs are summed on the device and
        the mean is packed and fetched once."""
        n, h, w = batch.shape
        pairs = dihedral_pairs(square=(h == w))
        force_bf16 = False
        with torch.inference_mode():
            accs = [torch.zeros((k, 2 * h, 2 * w), dtype=torch.float32,
                                device=r.device)
                    for r, k in zip(self._leads, self._chunks(batch)[1])]
            for i, (t, inv) in enumerate(pairs):
                bf16_before = self._quant_batches["bf16"]
                ys = self._dispatch_once(
                    np.ascontiguousarray(t(batch)), _quant_calib_ok=(i == 0),
                    _quant_count=(i == 0), _quant_force_bf16=force_bf16,
                    _pack=False)
                for acc, y in zip(accs, ys):
                    acc += inv(y)
                if i == 0:
                    # the identity pass alone is counted: it was served
                    # bf16 if it moved the bf16 count
                    force_bf16 = self._quant_batches["bf16"] > bf16_before
            ys = [pack_unit(acc / len(pairs), self.out_dtype) for acc in accs]
        return self._collect_all(self._start_fetches(ys))

    def _start_fetches(self, ys: List[torch.Tensor]) -> list:
        """:meth:`_start_fetch` of each device's result on its device."""
        return [self._start_fetch(y, r) for r, y in zip(self._leads, ys)]

    def _collect_all(self, handles: list) -> np.ndarray:
        """The fetched results of one batch, its devices' rows in order."""
        if len(handles) == 1:
            return self._collect(handles[0])
        return np.concatenate([self._collect(h) for h in handles])

    def _dispatch(self, batch: np.ndarray) -> List[torch.Tensor]:
        return (self._tta_dispatch(batch) if self.tta
                else self._dispatch_once(batch))

    def _dispatch_fetch(self, batch: np.ndarray) -> list:
        """One batch dispatched and its fetch queued: the handles for
        :meth:`_collect_all`."""
        with span("engine.dispatch"):
            return self._start_fetches(self._dispatch(batch))

    def upscale_batch(self, batch: np.ndarray) -> np.ndarray:
        """(N, h, w) float [0,1] -> (N, 2h, 2w) in ``out_dtype``; with
        ``normalize_inputs`` the batch is raw (uint8, int16, uint16 or
        float), and with ``transpose_io`` it is (N, w, h) and the result
        (N, 2w, 2h), C-contiguous.

        Runs at native spatial size by default (bucket=1): the model is
        fully convolutional, and spatial zero-padding would shift every
        GroupNorm's whole-image statistics. A bucket > 1 pads to a multiple
        of it, trading that exactness for fewer distinct shapes.

        With ``tta`` the result is the mean over the dihedral transforms
        of t^-1(upscale(t(x))): 8 transforms when h == w, the 4 flips
        otherwise.
        """
        if self.tta and not self._tta_on_device():
            return self._tta_host_loop(batch)
        return self._collect_all(self._dispatch_fetch(batch))

    def upscale_batches(self, batches,
                        depth: int = 2) -> Iterator[np.ndarray]:
        """Pipelined serving over an iterable of batches: yields exactly
        ``map(self.upscale_batch, batches)`` (the same values, order and
        int8/TTA state machine, which runs at dispatch time in batch
        order), but keeps up to ``depth`` batches dispatched before it
        waits for the oldest one's result. On the card the uploads are
        asynchronous from page-locked buffers and each result crosses to
        the host on a side stream while the next batches compute. Host-loop
        TTA batches (int8 still calibrating) flush the window and run
        alone; a freeze mid-stream re-opens it from the next batch. On
        several devices a batch's chunks are all queued before the oldest
        batch is waited for, so no device idles while another's next chunk
        could be queued."""
        depth = max(1, int(depth))
        window: deque = deque()
        for b in batches:
            if self.tta and not self._tta_on_device():
                while window:
                    yield self._collect_all(window.popleft())
                yield self.upscale_batch(b)
                continue
            window.append(self._dispatch_fetch(b))
            if len(window) > depth:
                yield self._collect_all(window.popleft())
        while window:
            yield self._collect_all(window.popleft())

    def upscale_image(self, image01: np.ndarray) -> np.ndarray:
        return self.upscale_batch(image01[None])[0]

    def upscale_tiled(self, image01: np.ndarray, tile: int = 256,
                      halo: int = 16) -> np.ndarray:
        """Tiled upscale with halo overlap, for slices too large for one
        forward: ``tile``-sized patches overlapping by ``halo`` pixels run
        as one batch, and the 2x interiors are stitched, so every seam
        keeps its full receptive field. Refused under
        ``normalize_inputs``, which would normalize each tile alone."""
        h, w = image01.shape
        if h <= tile and w <= tile:
            return self.upscale_image(image01)
        if self.normalize_inputs:
            raise ValueError(
                "normalize_inputs normalizes per forward-pass input, which "
                "under tiling would be per-TILE, not per-slice; normalize "
                "on the host for tiled serving")
        stride = tile - 2 * halo
        if stride <= 0:
            raise ValueError(f"tile ({tile}) must exceed 2 * halo ({halo})")
        ys = list(range(0, max(h - 2 * halo, 1), stride))
        xs = list(range(0, max(w - 2 * halo, 1), stride))
        # pad so that every tile lies inside the image
        pad_h = ys[-1] + tile - h if ys[-1] + tile > h else 0
        pad_w = xs[-1] + tile - w if xs[-1] + tile > w else 0
        padded = np.pad(image01, ((0, pad_h), (0, pad_w)), mode="reflect")

        tiles = np.stack([padded[y:y + tile, x:x + tile]
                          for y in ys for x in xs])
        up = self.upscale_batch(tiles)  # (n, 2 tile, 2 tile)

        out = np.zeros((2 * (h + pad_h), 2 * (w + pad_w)), self.out_dtype)
        i = 0
        for y in ys:
            for x in xs:
                # this tile's interior (its halo kept only at the borders)
                y0 = 0 if y == 0 else halo
                x0 = 0 if x == 0 else halo
                y1 = tile if y + tile >= h + pad_h else tile - halo
                x1 = tile if x + tile >= w + pad_w else tile - halo
                out[2 * (y + y0):2 * (y + y1), 2 * (x + x0):2 * (x + x1)] = \
                    up[i, 2 * y0:2 * y1, 2 * x0:2 * x1]
                i += 1
        return out[:2 * h, :2 * w]

    # ------------------------------------------------------------- metrics

    @staticmethod
    def calculate_metrics(output01: np.ndarray, target01: np.ndarray,
                          device=None) -> Dict[str, float]:
        """SSIM/RMSE/MAE (parity: scripts/infer.py:148-171); the target is
        bicubic-resized if shapes differ (scripts/infer.py:317-324). SSIM
        runs through the fused kernel B2 on the card."""
        dev = resolve_device(device)
        o = torch.from_numpy(np.ascontiguousarray(output01, np.float32)).to(dev)
        t = torch.from_numpy(np.ascontiguousarray(target01, np.float32)).to(dev)
        if o.shape != t.shape:
            logger.warning(
                f"Target shape {tuple(t.shape)} differs from output "
                f"{tuple(o.shape)}; resizing target with bicubic")
            t = resize(t, tuple(o.shape), Interp.CUBIC)
        o, t = o[None], t[None]
        return {
            "ssim": float(ssim_per_sample(o, t).mean()),
            "rmse": float(np.sqrt(float(mse(o, t)))),
            "mae": float(mae(o, t)),
        }

    # ------------------------------------------------------- single image

    def process_single_image(self, input_path: str, output_path: str,
                             target_path: Optional[str] = None,
                             show_comparison: bool = False,
                             show_diff: bool = False,
                             save_figures_to: Optional[str] = None,
                             ) -> Tuple[np.ndarray, Optional[Dict[str, float]]]:
        """Full single-image pipeline (parity: scripts/infer.py:230-396).
        Returns (output float [0,1] array, metrics or None)."""
        import cv2

        raw = cv2.imread(input_path, cv2.IMREAD_GRAYSCALE)
        if raw is None:
            raise RuntimeError(f"Error loading image {input_path}")
        h, w = raw.shape
        if h % 8 != 0 or w % 8 != 0:
            logger.warning(
                f"Input image dimensions ({h}x{w}) are not divisible by 8. "
                "Padded internally to the shape bucket.")
        inp01 = preprocess_image_array(raw)

        target01 = None
        if target_path and os.path.exists(target_path):
            traw = cv2.imread(target_path, cv2.IMREAD_GRAYSCALE)
            if traw is not None:
                target01 = preprocess_image_array(traw)
                logger.info(f"Loaded target image {target_path} with shape "
                            f"{target01.shape}")

        out01 = self.upscale_image(inp01)

        # histogram matching vs the normalized target (scripts/infer.py:278-314)
        out_adj = out01
        if target01 is not None:
            try:
                logger.info("Applying histogram matching using target image "
                            "as reference.")
                out_adj = np.clip(
                    match_histograms_np(out01, target01), 0.0, 1.0)
            except (ValueError, IndexError) as e:  # raw output (:311-313)
                logger.error(f"Error during histogram matching: {e}. "
                             "Using raw model output.")
                out_adj = out01

        metrics = None
        if target01 is not None:
            metrics = self.calculate_metrics(out01, target01, self.device)
            for k, v in metrics.items():
                logger.info(f"{k.upper()}: {v:.4f}")

        cv2.imwrite(output_path,
                    np.clip(out_adj * 255, 0, 255).astype(np.uint8))
        logger.info(f"Enhanced image saved to {output_path}")

        if (show_comparison or show_diff) and save_figures_to:
            self._save_figures(inp01, out_adj, target01, metrics,
                               show_diff, save_figures_to)
        return out_adj, metrics

    @staticmethod
    def _save_figures(inp01, out01, target01, metrics, show_diff,
                      save_path: str) -> None:
        """Comparison/diff figure (parity: scripts/infer.py:173-228);
        skipped, with a warning, without matplotlib."""
        from mri_superresolution_torch.utils.figures import pyplot

        plt = pyplot()
        if plt is None:
            return
        has_target = target01 is not None
        n_cols = 2 + int(has_target) + int(has_target and show_diff)
        plt.figure(figsize=(n_cols * 4, 5))
        plt.subplot(1, n_cols, 1)
        plt.imshow(inp01, cmap="gray")
        plt.title("Input Low-Resolution")
        plt.axis("off")
        plt.subplot(1, n_cols, 2)
        plt.imshow(out01, cmap="gray")
        plt.title("Super-Resolution Output")
        plt.axis("off")
        if has_target:
            plt.subplot(1, n_cols, 3)
            plt.imshow(target01, cmap="gray")
            plt.title("Ground Truth")
            plt.axis("off")
        if has_target and show_diff:
            t = target01
            if t.shape != out01.shape:
                t = resize(torch.from_numpy(t), out01.shape,
                           Interp.CUBIC).numpy()
            diff = np.abs(out01 - t)
            plt.subplot(1, n_cols, 4)
            im = plt.imshow(diff, cmap="hot", vmin=0, vmax=0.5)
            plt.title("Absolute Difference")
            plt.axis("off")
            plt.colorbar(im, fraction=0.046, pad=0.04)
        if metrics:
            text = "\n".join(f"{k.upper()}: {v:.4f}"
                             for k, v in metrics.items())
            plt.figtext(0.5, 0.01, text, ha="center", fontsize=12,
                        bbox={"facecolor": "orange", "alpha": 0.2, "pad": 5})
        plt.tight_layout()
        plt.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close()


def load_engine(cfg: InferConfig, device=None, num_devices: int = 1,
                devices=None) -> InferenceEngine:
    """Resolve the checkpoint (explicit path or best -> final -> any
    discovery, scripts/infer.py:74-95 + 416-423) and build an engine. The
    checkpoint's own model config wins over the caller's defaults.
    ``num_devices`` / ``devices``: the engine's device pool
    (:class:`InferenceEngine`)."""
    path = ckpt.resolve_checkpoint(cfg.checkpoint_dir, cfg.model.model_type,
                                   cfg.checkpoint_path)
    logger.info(f"Using checkpoint: {path}")
    params, meta = ckpt.load_params_any(path, cfg.model.model_type)
    model_cfg = cfg.model
    mc = (meta.get("config") or {}).get("model")
    if mc:
        model_cfg = model_config_from_dict(mc)
        logger.info(f"Model hyperparams from checkpoint: "
                    f"base_filters={model_cfg.base_filters}")
    # even a bare weight file carries the widths its shapes fix
    model_cfg, widths = with_weight_widths(model_cfg, params)
    if widths:
        logger.info(f"{model_cfg.model_type} widths from the weights: "
                    f"{widths}")
    quant_calib_path = cfg.quant_calib_path
    if cfg.quant == "int8" and not quant_calib_path:
        # a QAT checkpoint carries its frozen scales beside it: serve with
        # the scales it trained against instead of re-calibrating
        sidecar = ckpt.calib_sidecar_path(path)
        if os.path.exists(sidecar):
            quant_calib_path = sidecar
            logger.info(f"Found QAT calibration sidecar {sidecar}; "
                        f"serving with the trained activation scales")
    return InferenceEngine(model_cfg, params, bf16=cfg.bf16,
                           bucket=cfg.bucket, device=device,
                           spatial_shards=cfg.spatial_shards,
                           quant=cfg.quant,
                           quant_calib_slices=cfg.quant_calib_slices,
                           quant_min_foreground=cfg.quant_min_foreground,
                           quant_calib_path=quant_calib_path, tta=cfg.tta,
                           normalize_inputs=cfg.normalize_inputs,
                           out_dtype=cfg.out_dtype,
                           transpose_io=cfg.transpose_io,
                           num_devices=num_devices, devices=devices)
