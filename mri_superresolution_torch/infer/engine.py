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
from mri_superresolution_torch.ops.functional import pack_unit
from mri_superresolution_torch.ops.metrics import mae, match_histograms_np, mse
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
_LATER = {"tta": "A9", "quant": "A11", "spatial_shards": "A14",
          "normalize_inputs": "A4", "transpose_io": "A4"}


class InferenceEngine:
    """Holds the unet with its params on one device and serves padded,
    bucketed forwards."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 bf16: bool = True, bucket: int = 1, out_dtype=None,
                 device=None, tta: bool = False, quant: str = "none",
                 spatial_shards: int = 1, normalize_inputs: bool = False,
                 transpose_io: bool = False):
        asked = {"tta": tta, "quant": quant != "none",
                 "spatial_shards": spatial_shards != 1,
                 "normalize_inputs": normalize_inputs,
                 "transpose_io": transpose_io}
        for name, on in asked.items():
            if on:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP {_LATER[name]})")
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
            y = self.model(torch.from_numpy(x).to(self.device))
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
    return InferenceEngine(model_cfg, params, bf16=cfg.bf16,
                           bucket=cfg.bucket, device=device)
