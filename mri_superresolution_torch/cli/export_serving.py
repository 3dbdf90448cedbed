"""Export a checkpoint as a portable serving artifact (``torch.export``).

    python -m mri_superresolution_torch.cli.export_serving \
        --checkpoint_dir ./ckpt --out model.mrisrt [--shapes 256x256,256x192]
        [--mode plain|tta|int8 [--quant_calib scales.json]]
        [--serve_raw --raw_dtype int16] [--out_dtype int16] [--no_bf16]
        [--cpu]

Takes the flags and defaults of the JAX package's
``tools/export_serving.py``, with ``--platforms`` naming this port's
devices (``cuda,cpu``). It reads any checkpoint ``load_engine`` reads
(``.ckpt``, ``.msgpack``, ``.pth``, either package's), traces the programs
on the card (``--cpu``: on the CPU) and writes one artifact
(``infer/export.py``) that serves on both. In int8 mode the frozen scales
come from ``--quant_calib`` or from the QAT sidecar next to the resolved
checkpoint (either package's). The batch stays symbolic: pass every (H,
W) you will serve in ``--shapes``. Spatial (row-sharded) artifacts are
not ported: ``--spatial_*`` exit 1 naming ROADMAP A14.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Export a checkpoint as a portable serving artifact")
    ap.add_argument("--checkpoint_dir", default="./checkpoints")
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--model_type", default="unet",
                    choices=("unet", "unet_tpu", "edsr", "simple"))
    ap.add_argument("--base_filters", type=int, default=32)
    ap.add_argument("--out", required=True)
    ap.add_argument("--shapes", default="256x256",
                    help="comma-separated HxW list to specialize "
                         "(batch stays symbolic)")
    ap.add_argument("--platforms", default="cuda,cpu",
                    help="devices the artifact serves on")
    ap.add_argument("--mode", default="plain",
                    choices=("plain", "tta", "int8"),
                    help="which serving program to export: the plain "
                         "clipped forward, the whole dihedral TTA "
                         "ensemble, or the frozen-scale int8 forward "
                         "(scales from --quant_calib or the checkpoint's "
                         "QAT sidecar) with a plain fallback")
    ap.add_argument("--quant_calib", default=None,
                    help="int8 mode: JSON sidecar of frozen activation "
                         "scales (defaults to <checkpoint>.calib.json)")
    ap.add_argument("--serve_raw", action="store_true",
                    help="export the zero-copy volume contract (plain "
                         "mode only): raw --raw_dtype inputs in the "
                         "transposed (b, w, h) NIfTI layout, device-side "
                         "percentile normalize, outputs transposed back")
    ap.add_argument("--raw_dtype", default="int16",
                    choices=("uint8", "uint16", "int16", "float32"),
                    help="stored input dtype a --serve_raw artifact "
                         "accepts (one per artifact)")
    ap.add_argument("--out_dtype", default="float32",
                    choices=("float32", "int16", "uint8"),
                    help="pack outputs on the device (plain/tta modes)")
    ap.add_argument("--spatial_shards", type=int, default=1,
                    help="> 1 is not ported yet (ROADMAP A14)")
    ap.add_argument("--spatial_devices", type=int, default=0,
                    help="not ported yet (ROADMAP A14)")
    ap.add_argument("--spatial_batch", type=int, default=0,
                    help="not ported yet (ROADMAP A14)")
    ap.add_argument("--no_bf16", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="trace on the CPU instead of the GPU")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from mri_superresolution_torch.utils.logging import setup_logging
    logger = setup_logging("export.log")
    if args.spatial_shards != 1 or args.spatial_devices or \
            args.spatial_batch:
        logger.error("spatial (row-sharded) artifacts are not ported yet "
                     "(ROADMAP A14): drop --spatial_shards, "
                     "--spatial_devices and --spatial_batch")
        return 1
    try:
        shapes = []
        for tok in args.shapes.split(","):
            h, w = tok.lower().split("x")
            shapes.append((int(h), int(w)))

        from mri_superresolution_torch.config import InferConfig, ModelConfig
        from mri_superresolution_torch.infer.engine import load_engine
        from mri_superresolution_torch.infer.export import export_artifact
        from mri_superresolution_torch.models import quant_forward
        from mri_superresolution_torch.train import checkpoint as ckpt

        engine = load_engine(InferConfig(
            model=ModelConfig(model_type=args.model_type,
                              base_filters=args.base_filters),
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_path=args.checkpoint_path,
            bf16=not args.no_bf16), device="cpu" if args.cpu else None)
        mc = engine.model_cfg
        scales = None
        if args.mode == "int8":
            calib = args.quant_calib
            if not calib:
                # the sidecar next to the checkpoint load_engine resolved
                # (an explicit --checkpoint_path wins), never another one
                calib = ckpt.calib_sidecar_path(ckpt.resolve_checkpoint(
                    args.checkpoint_dir, args.model_type,
                    args.checkpoint_path))
            scales, saved_type = quant_forward.load_scales(calib)
            if saved_type != mc.model_type:
                logger.error(f"{calib} holds scales for {saved_type!r}, "
                             f"not {mc.model_type!r}")
                return 1
            print(f"int8 mode: {len(scales)} frozen scales from {calib}")
        export_artifact(args.out, engine.model.state_dict(), mc, shapes,
                        bf16=not args.no_bf16,
                        platforms=tuple(args.platforms.split(",")),
                        mode=args.mode, quant_scales=scales,
                        serve_raw=args.serve_raw, raw_dtype=args.raw_dtype,
                        out_dtype=args.out_dtype)
    except Exception as e:  # the CLI boundary: report and exit 1
        logger.exception(f"Export failed: {e}")
        return 1
    extra = (f" raw={args.raw_dtype}" if args.serve_raw else "") + \
        (f" out={args.out_dtype}" if args.out_dtype != "float32" else "")
    print(f"Wrote {args.out} ({os.path.getsize(args.out) / 2**20:.1f} MiB): "
          f"{mc.model_type} bf={mc.base_filters} mode={args.mode}{extra} "
          f"shapes={shapes} platforms={args.platforms} (batch symbolic)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
