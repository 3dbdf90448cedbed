"""Batched, shape-bucketed inference engine on one GPU.

Reference behaviour reproduced (scripts/infer.py): percentile-clip
[0.5, 99.5] + min-max normalize of inputs (:97-130), outputs clamped to
[0, 1] (:276), optional histogram matching against a normalized target
(:278-314), metrics with a bicubic target resize on shape mismatch
(:317-324), PNG and comparison/diff figure outputs (:173-228, 336-394).

Each batch is uploaded as it is, zero-padded to the shape bucket on the
card, run through the bf16 (or fp32) model of any family (``unet``,
``unet_tpu``, ``edsr``, ``simple``), clamped, cropped to exactly 2x
the input and, for uint8/int16 ``out_dtype``, packed on the card before
the fetch. The engine runs on the card unless ``device="cpu"`` is passed.
The serving options are the JAX engine's (``infer/engine.py`` there):

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
  forward.

``quant="int8"`` serves the int8 post-training-quantized model
(``models/quant_forward.py``) with the JAX engine's state machine
(``infer/engine.py:371-467`` there): streaming self-calibration on
content-rich batches, then frozen scales (saved to ``quant_calib_path`` if
given, or loaded from it), and near-empty batches on the bf16 model.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from collections import deque
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mri_superresolution_torch.config import (InferConfig, ModelConfig,
                                              model_config_from_dict)
from mri_superresolution_torch.infer.transfer import HostTransfers
from mri_superresolution_torch.kernels import ssim_per_sample
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.ops.functional import pack_unit
from mri_superresolution_torch.ops.metrics import mae, match_histograms_np, mse
from mri_superresolution_torch.ops.normalize import normalize_slices
from mri_superresolution_torch.ops.quant import FOREGROUND_INTENSITY
from mri_superresolution_torch.ops.resize import Interp, resize
from mri_superresolution_torch.ops.tta import dihedral_pairs, tta_ensemble
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.device import resolve_device
from mri_superresolution_torch.utils.weights import edsr_num_blocks

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


class InferenceEngine(HostTransfers):
    """Holds a model with its params on one device and serves padded,
    bucketed forwards."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 bf16: bool = True, bucket: int = 1, out_dtype=None,
                 device=None, tta: bool = False, quant: str = "none",
                 quant_calib_slices: int = 8,
                 quant_min_foreground: float = 0.05,
                 quant_calib_path: Optional[str] = None,
                 spatial_shards: int = 1, normalize_inputs: bool = False,
                 transpose_io: bool = False):
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
        if spatial_shards != 1:
            raise NotImplementedError(
                "spatial_shards is not ported yet (ROADMAP A14)")
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
        self.device = resolve_device(device)
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
        self.bucket = bucket
        # results cross to the host on this stream, beside the next forward
        self._d2h = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)

        self.quant = quant
        self.quant_calib_path = quant_calib_path
        self.quant_calib_slices = quant_calib_slices
        self.quant_min_foreground = quant_min_foreground
        # views of the model's params, for the functional forwards
        self._params = self.model.state_dict()
        self._quant_scales = None    # frozen per-site scales; None while
        #                              calibrating
        self._quant_fwd = None       # int8 forward, built on freeze
        self._calib_amax: Dict[str, np.ndarray] = {}
        self._calib_seen = 0         # real (unpadded) slices calibrated on
        self._quant_batches = {"int8": 0, "bf16": 0}
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

    def _build_int8(self, scales) -> None:
        """Freeze ``scales`` into the int8 forward (validates that they
        cover every site)."""
        self._quant_fwd = quant_forward.build_int8_forward(
            self._params, scales, self.model_cfg.model_type,
            dtype=self._dtype)
        self._quant_scales = scales

    def _served(self, mode: str, count: bool) -> None:
        """Count a batch of the int8 path at the precision it is served
        at (unless ``count`` is False)."""
        if count:
            self._quant_batches[mode] += 1

    def _quant_upscale(self, x: torch.Tensor, n_real_slices: int,
                       foreground_frac: float, calib_ok: bool = True,
                       count: bool = True,
                       force_bf16: bool = False) -> torch.Tensor:
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
        stays bf16 even when that pass froze the scales."""
        if (force_bf16 or foreground_frac < self.quant_min_foreground
                or (self._quant_scales is None and not calib_ok)):
            self._served("bf16", count)
            return self.model(x)
        if self._quant_scales is None:
            first = self._calib_seen == 0
            y, amax = quant_forward.build_calib_forward(
                self.model_cfg.model_type, dtype=self._dtype)(self._params, x)
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
                return y
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
                return y
        self._served("int8", count)
        return self._quant_fwd(self._params, x)

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
        return (_round_up(max(h, 8), self.bucket),
                _round_up(max(w, 8), self.bucket))

    @staticmethod
    def _foreground(batch: np.ndarray) -> float:
        """Fraction of the batch's real pixels above FOREGROUND_INTENSITY
        (the int8 routing's measure, taken on the host)."""
        return float((np.abs(batch) > FOREGROUND_INTENSITY).mean())

    def _device_input(self, batch: np.ndarray, bh: int,
                      bw: int) -> torch.Tensor:
        """The (n, h, w) batch — (n, w, h) under ``transpose_io`` — as the
        forward's (max(n, 1), bh, bw, 1) fp32 input on the device. The raw
        batch is uploaded as it is; then, on the device: cast to fp32,
        swap the axes (``transpose_io``), normalize per slice
        (``normalize_inputs``) and zero-pad to (bh, bw), so that the
        percentiles see only real pixels. Runs under inference mode."""
        if batch.shape[0] == 0:
            batch = np.zeros((1,) + batch.shape[1:], batch.dtype)
        x = self._upload(batch).float()
        if self.transpose_io:
            x = x.transpose(1, 2)
        if self.normalize_inputs:
            x = normalize_slices(x)
        h, w = x.shape[1:]
        if (bh, bw) != (h, w):
            x = F.pad(x, (0, bw - w, 0, bh - h))
        return x[..., None]

    def _dispatch_once(self, batch: np.ndarray,
                       _quant_calib_ok: bool = True,
                       _quant_count: bool = True,
                       _quant_force_bf16: bool = False,
                       _pack: bool = True) -> torch.Tensor:
        """Upload -> (normalize) -> pad -> forward -> clip -> crop ->
        (transpose) -> pack, queued on the device; nothing is fetched.
        The ``_quant_*`` arguments are :meth:`_quant_upscale`'s, for the
        host TTA loop, which also fetches its members unpacked."""
        n = batch.shape[0]
        h, w = ((batch.shape[2], batch.shape[1]) if self.transpose_io
                else (batch.shape[1], batch.shape[2]))
        bh, bw = self._bucket_hw(h, w)
        with torch.inference_mode():
            x = self._device_input(batch, bh, bw)
            if self.quant == "int8":
                y = self._quant_upscale(
                    x, n, self._foreground(batch), calib_ok=_quant_calib_ok,
                    count=_quant_count, force_bf16=_quant_force_bf16)
            else:
                y = self.model(x)
            y = y.clamp(0.0, 1.0)[:n, :2 * h, :2 * w, 0]
            if self.transpose_io:
                # (N, 2w, 2h): .T of the fetched batch is the F-order
                # output volume
                y = y.transpose(1, 2)
            return pack_unit(y, self.out_dtype) if _pack else y

    def _tta_on_device(self) -> bool:
        """True when a --tta batch runs as one card-resident ensemble: bf16
        and fp32 always, int8 once its scales are frozen. Still-calibrating
        int8 runs the host loop (its routing state machine lives on the
        host); the switch goes host -> device once, never back."""
        return self.quant != "int8" or self._quant_scales is not None

    def _tta_dispatch(self, batch: np.ndarray) -> torch.Tensor:
        """The dihedral ensemble on the card (``ops/tta.py``): one upload,
        normalized once if ``normalize_inputs`` (the percentiles and the
        min/max do not change under a dihedral transform), each member
        padded to the bucket after its transform and cropped before its
        inverse, the members summed in fp32, the mean packed. Frozen int8
        takes one routing decision a batch (the transforms keep the
        foreground fraction), counted as one batch."""
        n, h, w = batch.shape
        mode = "bf16"
        if self.quant == "int8":
            if self._foreground(batch) >= self.quant_min_foreground:
                mode = "int8"
            self._served(mode, count=True)
        if mode == "int8":
            def forward(a):
                return self._quant_fwd(self._params, a).clamp(0.0, 1.0)
        else:
            def forward(a):
                return self.model(a).clamp(0.0, 1.0)
        with torch.inference_mode():
            x = self._device_input(batch, h, w)
            y = tta_ensemble(forward, x, self._bucket_hw)
            return pack_unit(y[:n, :, :, 0], self.out_dtype)

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
            acc = torch.zeros((n, 2 * h, 2 * w), dtype=torch.float32,
                              device=self.device)
            for i, (t, inv) in enumerate(pairs):
                bf16_before = self._quant_batches["bf16"]
                acc += inv(self._dispatch_once(
                    np.ascontiguousarray(t(batch)), _quant_calib_ok=(i == 0),
                    _quant_count=(i == 0), _quant_force_bf16=force_bf16,
                    _pack=False))
                if i == 0:
                    # the identity pass alone is counted: it was served
                    # bf16 if it moved the bf16 count
                    force_bf16 = self._quant_batches["bf16"] > bf16_before
            y = pack_unit(acc / len(pairs), self.out_dtype)
        return self._collect(self._start_fetch(y))

    def _dispatch(self, batch: np.ndarray) -> torch.Tensor:
        return (self._tta_dispatch(batch) if self.tta
                else self._dispatch_once(batch))

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
        return self._collect(self._start_fetch(self._dispatch(batch)))

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
        alone; a freeze mid-stream re-opens it from the next batch."""
        depth = max(1, int(depth))
        window: deque = deque()
        for b in batches:
            if self.tta and not self._tta_on_device():
                while window:
                    yield self._collect(window.popleft())
                yield self.upscale_batch(b)
                continue
            window.append(self._start_fetch(self._dispatch(b)))
            if len(window) > depth:
                yield self._collect(window.popleft())
        while window:
            yield self._collect(window.popleft())

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


def load_engine(cfg: InferConfig, device=None) -> InferenceEngine:
    """Resolve the checkpoint (explicit path or best -> final -> any
    discovery, scripts/infer.py:74-95 + 416-423) and build an engine. The
    checkpoint's own model config wins over the caller's defaults."""
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
    if model_cfg.model_type == "edsr":
        # a bare weight file carries its depth in its blocks
        model_cfg = dataclasses.replace(
            model_cfg, num_blocks=edsr_num_blocks(params))
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
                           transpose_io=cfg.transpose_io)
