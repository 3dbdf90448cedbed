"""Export a checkpoint as a portable serving artifact (``torch.export``).

    python -m mri_superresolution_torch.cli.export_serving \
        --checkpoint_dir ./ckpt --out model.mrisrt [--shapes 256x256,256x192]
        [--mode plain|tta|int8 [--quant_calib scales.json]]
        [--serve_raw --raw_dtype int16] [--out_dtype int16] [--no_bf16]
        [--spatial_shards 2 --spatial_devices 2 [--spatial_batch 4]]
        [--cpu]

Takes the flags and defaults of the JAX package's
``tools/export_serving.py``, with ``--platforms`` naming this port's
devices (``cuda,cpu``). It reads any checkpoint ``load_engine`` reads
(``.ckpt``, ``.msgpack``, ``.pth``, either package's), traces the programs
on the card (``--cpu``: on the CPU) and writes one artifact
(``infer/export.py``) that serves on both. In int8 mode the frozen scales
come from ``--quant_calib`` or from the QAT sidecar next to the resolved
checkpoint (either package's). The batch stays symbolic: pass every (H,
W) you will serve in ``--shapes``. ``--spatial_shards S`` > 1 exports
the row-sharded forward over ``--spatial_devices`` devices (0: the
visible cards, 1 with ``--cpu``; S must divide it) with a fixed batch,
``--spatial_batch`` (0: the data-group count); its shapes need H % (8 S)
== 0 and W % 8 == 0, and ``--serve_raw`` is refused (``infer/export.py``).
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    from mri_superresolution_torch.models.families import (FAMILIES,
                                                            model_flags)
    ap = argparse.ArgumentParser(
        description="Export a checkpoint as a portable serving artifact")
    ap.add_argument("--checkpoint_dir", default="./checkpoints")
    ap.add_argument("--checkpoint_path", default=None)
    fill = model_flags(ap, base_filters=32, model_help=", ".join(
        n for n, f in FAMILIES.items() if not f.exports) + " is refused: "
        "its window-attention kernel has no exported operator")
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
                    help="> 1: export the row-sharded forward, each "
                         "slice's rows split over this many devices")
    ap.add_argument("--spatial_devices", type=int, default=0,
                    help="devices of the spatial grid (0 = the visible "
                         "cards; 1 with --cpu)")
    ap.add_argument("--spatial_batch", type=int, default=0,
                    help="fixed batch of a spatial program (0 = the "
                         "data-group count)")
    ap.add_argument("--no_bf16", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="trace on the CPU instead of the GPU")
    return fill(ap.parse_args(argv))


def main(argv=None) -> int:
    args = parse_args(argv)

    from mri_superresolution_torch.utils.logging import setup_logging
    logger = setup_logging("export.log")
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
                        out_dtype=args.out_dtype,
                        spatial_shards=args.spatial_shards,
                        spatial_devices=args.spatial_devices,
                        spatial_batch=args.spatial_batch)
    except Exception as e:  # the CLI boundary: report and exit 1
        logger.exception(f"Export failed: {e}")
        return 1
    spatial = args.spatial_shards > 1
    extra = (f" raw={args.raw_dtype}" if args.serve_raw else "") + \
        (f" out={args.out_dtype}" if args.out_dtype != "float32" else "") + \
        (f" spatial={args.spatial_shards}" if spatial else "")
    print(f"Wrote {args.out} ({os.path.getsize(args.out) / 2**20:.1f} MiB): "
          f"{mc.model_type} bf={mc.base_filters} mode={args.mode}{extra} "
          f"shapes={shapes} platforms={args.platforms} "
          + ("(concrete batch per spatial program)" if spatial
             else "(batch symbolic)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
