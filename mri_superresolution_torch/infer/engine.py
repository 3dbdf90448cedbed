"""Batched, shape-bucketed inference engine on one GPU.

Reference behaviour reproduced (scripts/infer.py): percentile-clip
[0.5, 99.5] + min-max normalize of inputs (:97-130), outputs clamped to
[0, 1] (:276), optional histogram matching against a normalized target
(:278-314), metrics with a bicubic target resize on shape mismatch
(:317-324), PNG and comparison/diff figure outputs (:173-228, 336-394).

Each batch is zero-padded to the shape bucket on the host, uploaded,
run through the bf16 (or fp32) unet, clamped, cropped to exactly 2x the
input and, for uint8/int16 ``out_dtype``, packed on the card before the
fetch. The engine runs on the card unless ``device="cpu"`` is passed.

``quant="int8"`` serves the int8 post-training-quantized unet
(``models/quant_forward.py``) with the JAX engine's state machine
(``infer/engine.py:371-467`` there): streaming self-calibration on
content-rich batches, then frozen scales (saved to ``quant_calib_path`` if
given, or loaded from it), and near-empty batches on the bf16 model.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mri_superresolution_torch.config import (InferConfig, ModelConfig,
                                              model_config_from_dict)
from mri_superresolution_torch.kernels import ssim_per_sample
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward
from mri_superresolution_torch.ops.functional import pack_unit
from mri_superresolution_torch.ops.metrics import mae, match_histograms_np, mse
from mri_superresolution_torch.ops.quant import FOREGROUND_INTENSITY
from mri_superresolution_torch.ops.resize import Interp, resize
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.device import resolve_device

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


# Serving options of the JAX engine that later slices port, with the
# ROADMAP item that carries each.
_LATER = {"tta": "A9", "spatial_shards": "A14",
          "normalize_inputs": "A4", "transpose_io": "A4"}


class InferenceEngine:
    """Holds the unet with its params on one device and serves padded,
    bucketed forwards."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 bf16: bool = True, bucket: int = 1, out_dtype=None,
                 device=None, tta: bool = False, quant: str = "none",
                 quant_calib_slices: int = 8,
                 quant_min_foreground: float = 0.05,
                 quant_calib_path: Optional[str] = None,
                 spatial_shards: int = 1, normalize_inputs: bool = False,
                 transpose_io: bool = False):
        if normalize_inputs and quant == "int8":
            raise ValueError(
                "normalize_inputs is incompatible with --quant int8: the "
                "engine's content-aware routing reads normalized [0,1] "
                "pixels on the host; normalize on the host for int8 "
                "serving")
        asked = {"tta": tta, "spatial_shards": spatial_shards != 1,
                 "normalize_inputs": normalize_inputs,
                 "transpose_io": transpose_io}
        for name, on in asked.items():
            if on:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP {_LATER[name]})")
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
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.out_dtype = np.dtype(out_dtype if out_dtype is not None
                                  else np.float32)
        if self.out_dtype not in _OUT_DTYPES:
            raise ValueError(f"out_dtype must be float32/uint8/int16, got "
                             f"{self.out_dtype}")
        self._dtype = torch.bfloat16 if bf16 else torch.float32
        self.model = build_model(model_cfg, dtype=self._dtype)
        self.model.load_state_dict(params, strict=True)
        self.model.to(self.device).eval()
        self.bucket = bucket

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

    def _quant_upscale(self, x: torch.Tensor, n_real_slices: int,
                       foreground_frac: float) -> torch.Tensor:
        """int8 PTQ serving with streaming self-calibration. Content-rich
        batches run the bf16 calib forward, which records each conv site's
        per-input-channel max |x|, until ``quant_calib_slices`` real slices
        have been seen; then the scales freeze and later batches run int8.
        A batch that completes calibration by itself is re-served int8 (so
        a one-image ``--quant int8`` run gives int8 output).

        ``foreground_frac`` is taken on the real pixels, before zero
        padding. Batches below ``quant_min_foreground`` neither calibrate
        nor run int8: they serve on the bf16 model, where int8 noise would
        dominate their small error."""
        if foreground_frac < self.quant_min_foreground:
            self._quant_batches["bf16"] += 1
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
                self._quant_batches["bf16"] += 1
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
                self._quant_batches["bf16"] += 1
                return y
        self._quant_batches["int8"] += 1
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

    def _dispatch_once(self, batch: np.ndarray) -> torch.Tensor:
        """Pad -> upload -> forward -> clip -> crop -> pack, enqueued on the
        device; the returned tensor is not fetched."""
        n, h, w = batch.shape
        bh, bw = self._bucket_hw(h, w)
        x = np.zeros((max(n, 1), bh, bw, 1), np.float32)
        x[:n, :h, :w, 0] = batch
        with torch.inference_mode():
            xd = torch.from_numpy(x).to(self.device)
            if self.quant == "int8":
                y = self._quant_upscale(
                    xd, n, float((np.abs(batch) > FOREGROUND_INTENSITY)
                                 .mean()))
            else:
                y = self.model(xd)
            y = y.clamp(0.0, 1.0)[:n, :2 * h, :2 * w, 0]
            return pack_unit(y, self.out_dtype)

    def upscale_batch(self, batch: np.ndarray) -> np.ndarray:
        """(N, h, w) float [0,1] -> (N, 2h, 2w) in ``out_dtype``.

        Runs at native spatial size by default (bucket=1): the model is
        fully convolutional, and spatial zero-padding would shift every
        GroupNorm's whole-image statistics. A bucket > 1 pads to a multiple
        of it, trading that exactness for fewer distinct shapes.
        """
        return self._dispatch_once(batch).cpu().numpy()

    def upscale_image(self, image01: np.ndarray) -> np.ndarray:
        return self.upscale_batch(image01[None])[0]

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
        """Comparison/diff figure (parity: scripts/infer.py:173-228)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

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
    params, meta = ckpt.load_params_any(path)
    model_cfg = cfg.model
    mc = (meta.get("config") or {}).get("model")
    if mc:
        model_cfg = model_config_from_dict(mc)
        logger.info(f"Model hyperparams from checkpoint: "
                    f"base_filters={model_cfg.base_filters}")
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
                           bucket=cfg.bucket, device=device, quant=cfg.quant,
                           quant_calib_slices=cfg.quant_calib_slices,
                           quant_calib_path=quant_calib_path)
