"""Single-image super-resolution inference on the GPU.

    python -m mri_superresolution_torch.cli.infer --input lr.png \
        --output sr.png [--target hr.png] [--checkpoint_dir ./checkpoints]
        [--quant int8 [--quant_calib scales.json]] [--tta]

Takes the flags of the JAX package's ``scripts/infer.py`` (reference
scripts/infer.py:452-486). Runs on the card; ``--cpu`` runs on the CPU.
Checkpoints carry their hyperparams, so ``--base_filters`` is only a
fallback for bare weight files. ``--artifact`` serves a portable artifact
(``cli/export_serving.py``) instead of a checkpoint, with no model code:
as in JAX, ``--tta`` and ``--quant`` that the artifact does not export,
and ``--bucket``, are named as ignored.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="MRI quality enhancement inference")
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--target', type=str, default=None)
    parser.add_argument('--checkpoint_dir', type=str, default='./checkpoints')
    parser.add_argument('--checkpoint_path', type=str, default=None)
    parser.add_argument('--model_type', type=str,
                        choices=['unet', 'unet_tpu', 'edsr', 'simple'],
                        default='unet')
    parser.add_argument('--base_filters', type=int, default=64)
    parser.add_argument('--show_comparison', action='store_true')
    parser.add_argument('--show_diff', action='store_true')
    parser.add_argument('--save_figure', type=str, default=None,
                        help='Write the comparison/diff figure to this path')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU instead of the GPU')
    parser.add_argument('--use_amp', action='store_true',
                        help='Reference-compat alias: bf16 is the default')
    parser.add_argument('--no_bf16', action='store_true')
    parser.add_argument('--bucket', type=int, default=1,
                        help='Pad inputs to a multiple of this (1 = native '
                             'size, GroupNorm-exact)')
    parser.add_argument('--quant', type=str, choices=['none', 'int8'],
                        default='none',
                        help='int8 PTQ serving: per-channel scales self-'
                             'calibrated on this image, then the int8 '
                             'forward produces the output')
    parser.add_argument('--quant_calib_slices', type=int, default=1,
                        help='slices of streaming calibration before int8 '
                             'serving starts (single-image default: 1, so '
                             'the output IS int8-served)')
    parser.add_argument('--quant_calib', type=str, default=None,
                        metavar='PATH',
                        help='JSON sidecar of frozen int8 scales: loaded if '
                             'it exists (int8 from the first batch), '
                             'otherwise written after self-calibration')
    parser.add_argument('--tta', action='store_true',
                        help='Test-time augmentation: average the forward '
                             'over the dihedral flips (8 transforms for '
                             'square inputs, 4 otherwise)')
    parser.add_argument('--artifact', type=str, default=None,
                        help='Serve from a portable artifact '
                             '(python -m mri_superresolution_torch.cli.'
                             'export_serving) instead of a checkpoint: '
                             'weights and exported programs in one file, '
                             'no model code needed. The input size must be '
                             'among the exported shapes.')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from mri_superresolution_torch.utils.logging import setup_logging

    logger = setup_logging("inference.log")
    device = "cpu" if args.cpu else None
    try:
        if args.artifact:
            from mri_superresolution_torch.infer.export import load_artifact
            engine = load_artifact(args.artifact, device=device)
            ignored = [name for name, on in
                       (("--tta", args.tta and engine.mode != "tta"),
                        ("--quant", args.quant != "none"
                         and engine.mode != "int8"),
                        ("--bucket", args.bucket != 1))
                       if on]
            if ignored:
                logger.warning(
                    f"--artifact serves its exported program "
                    f"(mode={engine.mode}); {', '.join(ignored)} are "
                    "IGNORED: export a dedicated artifact (cli."
                    "export_serving --mode tta|int8) or serve from a "
                    "checkpoint for those modes")
            logger.info(f"Serving from artifact {args.artifact}: "
                        f"{engine.model_type} mode={engine.mode}, shapes "
                        f"{engine.shapes} on {engine.device} (no model "
                        "code loaded)")
        else:
            from mri_superresolution_torch.config import (InferConfig,
                                                          ModelConfig)
            from mri_superresolution_torch.infer import load_engine
            cfg = InferConfig(
                model=ModelConfig(model_type=args.model_type,
                                  base_filters=args.base_filters),
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_path=args.checkpoint_path,
                bf16=not args.no_bf16, bucket=args.bucket, quant=args.quant,
                quant_calib_slices=args.quant_calib_slices,
                quant_calib_path=args.quant_calib, tta=args.tta)
            engine = load_engine(cfg, device=device)
        fig_path = args.save_figure
        if (args.show_comparison or args.show_diff) and not fig_path:
            fig_path = os.path.splitext(args.output)[0] + "_comparison.png"
        engine.process_single_image(
            input_path=args.input,
            output_path=args.output,
            target_path=args.target,
            show_comparison=args.show_comparison,
            show_diff=args.show_diff,
            save_figures_to=fig_path)
        if args.quant != 'none' and not args.artifact:
            logger.info(engine.quant_summary())
        logger.info("Inference completed successfully!")
        return 0
    except Exception as e:  # the CLI boundary: report and exit 1
        logger.exception(f"Error during inference: {e}")
        return 1


if __name__ == '__main__':
    sys.exit(main())
