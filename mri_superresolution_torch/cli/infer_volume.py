"""Whole-volume super-resolution on the GPU: NIfTI in, 2x in-plane NIfTI out.

    python -m mri_superresolution_torch.cli.infer_volume --input vol.nii.gz \
        --output sr.nii.gz [--checkpoint_dir ./checkpoints] [--batch_size 64]
        [--serve_raw] [--out_dtype int16] [--tta] [--quant int8] [--cpu]

The port's counterpart of the JAX package's ``scripts/infer_volume.py``,
with its flags and defaults. Every axial slice is normalized per slice
(percentile window + min-max) on the card and super-resolved in batches
through ``InferenceEngine.upscale_batches``; the volume is written back
with halved in-plane spacing and, for integer outputs, the ``scl_slope``
that decodes them to [0, 1]. Slices larger than ``--tile`` take
``upscale_tiled``. ``--serve_raw`` uploads the stored voxels and
normalizes them on the card with no host copy (the engine's
``transpose_io``). ``--input`` may be a directory: every volume in it is
served through one loaded engine, and a volume that fails is counted, not
fatal. Runs on the card; ``--cpu`` runs on the CPU. ``--artifact`` serves
a portable artifact (``cli/export_serving.py``) with no model code,
under the JAX CLI's policy: a flag the artifact exports is satisfied, one
that conflicts with it exits 1, ``--bucket`` and ``--num_devices`` are
named as ignored, and a volume whose shape has no program is padded to
the smallest exported shape that fits, or refused for raw and tta
artifacts. ``--num_devices`` (default 0: every visible GPU; with
``--cpu`` that many CPU devices, 0 = 1) splits each batch over a copy of
the model on each device. ``--spatial_shards S`` > 1 splits each
slice's rows over S devices (``parallel/spatial.py``) and the batch over
``--num_devices`` / S data groups, as the JAX CLI does: S must divide the
device count, and a slice is zero-padded to H % (8 S) == 0 and W % 8 == 0
with a warning (its GroupNorm statistics then differ from the dense
forward's). With ``--spatial_shards`` the device slots may outnumber the
cards, which are then named in turn (``--num_devices 2 --spatial_shards
2`` on one card). A spatial artifact serves its exported shapes only,
and ``--spatial_shards`` beside an artifact must be its own.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def parse_args(argv=None):
    from mri_superresolution_torch.models.families import model_flags
    parser = argparse.ArgumentParser(
        description="Super-resolve a whole NIfTI volume (2x in-plane)")
    parser.add_argument('--input', type=str, required=True,
                        help='Input .nii/.nii.gz volume, or a DIRECTORY: '
                             'every volume in it is served through the one '
                             'loaded engine, outputs written as '
                             '<stem>_sr.nii* under --output')
    parser.add_argument('--output', type=str, required=True,
                        help='Output .nii/.nii.gz volume (or output '
                             'directory when --input is a directory)')
    parser.add_argument('--checkpoint_dir', type=str, default='./checkpoints')
    parser.add_argument('--checkpoint_path', type=str, default=None)
    parser.add_argument('--artifact', type=str, default=None,
                        help='Serve from a portable artifact (cli.'
                             'export_serving) instead of a checkpoint')
    fill = model_flags(parser, base_filters=32)
    parser.add_argument('--batch_size', type=int, default=64,
                        help='Slices per forward pass')
    parser.add_argument('--tile', type=int, default=512,
                        help='Use halo-tiled inference above this slice size')
    parser.add_argument('--num_devices', type=int, default=0,
                        help='Devices each batch is split over (0 = every '
                             'visible GPU; with --cpu, CPU devices, 0 = 1)')
    parser.add_argument('--save_png_dir', type=str, default=None,
                        help='Optionally also dump per-slice PNGs here')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU instead of the GPU')
    parser.add_argument('--no_bf16', action='store_true')
    parser.add_argument('--bucket', type=int, default=1,
                        help='Pad slices to a multiple of this before the '
                             'forward (1 = native size)')
    parser.add_argument('--quant', type=str, choices=['none', 'int8'],
                        default='none',
                        help='int8 PTQ serving: streaming self-calibration '
                             'over the first batches (served bf16), then '
                             'int8 (see --quant_calib_slices)')
    parser.add_argument('--quant_calib_slices', type=int, default=8,
                        help='slices of streaming calibration before int8 '
                             'serving starts')
    parser.add_argument('--quant_calib', type=str, default=None,
                        metavar='PATH',
                        help='JSON sidecar of frozen int8 scales: loaded if '
                             'it exists (int8 from the first batch), '
                             'otherwise written after self-calibration')
    parser.add_argument('--spatial_shards', type=int, default=1,
                        help='Split each slice\'s rows over this many '
                             'devices (halo-exchange spatial parallelism) '
                             'for slices too large for one; must divide '
                             'the device count (--num_devices)')
    parser.add_argument('--tta', action='store_true',
                        help='Test-time augmentation: average the forward '
                             'over the dihedral flips (8 transforms for '
                             'square slices, 4 otherwise)')
    parser.add_argument('--serve_raw', action='store_true',
                        help='Upload the stored voxel values (e.g. int16) '
                             'and normalize them on the card: less '
                             'host->device transfer and no host percentile '
                             'cost. Exact: the percentile + min-max '
                             'normalize is invariant to the NIfTI scl_slope '
                             'it skips. Not available with --quant int8.')
    parser.add_argument('--out_dtype', type=str, default='float32',
                        choices=['float32', 'int16', 'uint8'],
                        help='Output voxel coding. int16/uint8 pack '
                             'round(y*32767 / y*255) on the card and store '
                             'the NIfTI scl_slope that decodes back to '
                             '[0,1]; float32 = exact.')
    return fill(parser.parse_args(argv))


def artifact_conflicts(args, art) -> tuple:
    """(refused, ignored) flag names beside a loaded artifact: a mode the
    artifact exports is satisfied, one it cannot serve is refused, and
    the flags it has no use for are ignored (the JAX CLI's policy)."""
    refused = [name for name, on in (
        ("--quant", args.quant != "none" and art.mode != "int8"),
        ("--spatial_shards", args.spatial_shards != 1
         and (art.spatial or {}).get("n_space") != args.spatial_shards),
        ("--serve_raw", args.serve_raw and not art.normalize_inputs),
        ("--out_dtype", args.out_dtype != "float32"
         and np.dtype(args.out_dtype) != art.out_dtype),
        ("--tta", args.tta and art.mode != "tta")) if on]
    ignored = [name for name, on in (("--bucket", args.bucket != 1),
                                     ("--num_devices", args.num_devices != 0))
               if on]
    return refused, ignored


def _normalize_stack(stack: np.ndarray, device) -> np.ndarray:
    """Per-slice percentile window + min-max of an (n, h, w) stack on the
    engine's device, fetched back to the host: on the card into
    page-locked memory, which the engine's batches upload from with no
    host copy."""
    import torch
    from mri_superresolution_torch.ops.normalize import normalize_slices
    with torch.inference_mode():
        y = normalize_slices(torch.from_numpy(stack).to(device))
        if y.device.type == "cpu":
            return y.numpy()
        out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        out.copy_(y)
        return out.numpy()


def _artifact_shape_ok(art, h: int, w: int, logger) -> bool:
    """Whether the artifact serves an h x w volume: exactly, or padded to
    an exported shape, which raw and tta artifacts refuse."""
    if (h, w) in art.shapes:
        return True
    if art.normalize_inputs:
        logger.error(
            f"serve_raw artifact has no program for {h}x{w} and cannot "
            "pad (zero pads would dilute the device-side normalize); "
            f"re-export with this exact shape (exported: {art.shapes})")
        return False
    if art.mode == "tta":
        logger.error(
            f"tta-mode artifact has no program for {h}x{w} and cannot "
            "serve it by padding (the exported ensemble would transform "
            "the zero margin); re-export with this exact shape "
            f"(exported: {art.shapes})")
        return False
    if art.spatial:
        logger.error(
            f"spatial artifact has no program for {h}x{w} and cannot serve "
            f"it by padding (H must stay % {8 * art.spatial['n_space']}); "
            f"re-export with this exact shape (exported: {art.shapes})")
        return False
    logger.warning(
        f"No exact program for {h}x{w}; slices will be zero-padded to the "
        "smallest fitting exported shape (the engine's bucket padding, "
        "with its GroupNorm-statistics caveat)")
    return True


def _serve_one(args, engine, logger, input_path: str,
               output_path: str, art=None) -> int:
    """Serve one volume through the loaded engine or artifact ``art``
    (``engine`` None); 0 or 1, as a CLI."""
    from mri_superresolution_torch import nifti
    from mri_superresolution_torch.ops.functional import unit_slope

    # a raw artifact exports the raw transposed contract; the host path
    # is then the engine's --serve_raw path
    serve_raw = args.serve_raw or (art is not None and art.normalize_inputs)
    transposed = serve_raw and not args.tta
    backend = engine if art is None else art
    data, hdr = nifti.load(input_path, raw=serve_raw)
    if data.ndim == 4:
        logger.info("4D input: super-resolving timepoint 0")
        data = data[:, :, :, 0]
    if data.ndim != 3:
        logger.error(f"Expected a 3D volume, got {data.ndim}D")
        return 1
    h, w, n_slices = data.shape
    logger.info(f"Volume {input_path}: {h}x{w}, {n_slices} slices"
                + (f" (raw {data.dtype} served)" if serve_raw else ""))
    if art is not None and not _artifact_shape_ok(art, h, w, logger):
        return 1

    if transposed:
        # the volume's F-order (h, w, n) buffer is a C-order (n, w, h)
        # array: data.T is contiguous already, and the engine swaps the
        # axes on the card both ways
        norm = np.ascontiguousarray(data.T)
    elif serve_raw:
        norm = np.ascontiguousarray(np.transpose(data, (2, 0, 1)))
    else:
        stack = np.ascontiguousarray(np.transpose(data, (2, 0, 1)))
        norm = _normalize_stack(stack.astype(np.float32), backend.device)

    if art is not None:
        starts = list(range(0, n_slices, args.batch_size))
        outs = []
        try:
            with art.page_locked(norm):
                for start, out in zip(starts, art.upscale_batches(
                        (norm[s:s + args.batch_size] for s in starts),
                        pad=True)):
                    outs.append(out)
                    logger.info(f"Upscaled slices {start}.."
                                f"{start + len(out) - 1}")
        except ValueError as e:
            logger.error(str(e))
            return 1
        sr = np.concatenate(outs, axis=0)
    elif max(h, w) > args.tile:
        logger.info(f"Slice {h}x{w} exceeds tile={args.tile}; "
                    "using halo-tiled inference")
        if args.serve_raw:
            logger.error("--serve_raw does not support the tiled path "
                         "(per-tile normalize would differ); rerun "
                         "without it")
            return 1
        sr = np.stack([engine.upscale_tiled(norm[i], tile=args.tile)
                       for i in range(n_slices)])
    else:
        starts = list(range(0, n_slices, args.batch_size))
        outs = []
        # the batches are views of one page-locked stack: each uploads
        # from it with no host copy
        with engine.page_locked(norm):
            for start, out in zip(starts, engine.upscale_batches(
                    norm[s:s + args.batch_size] for s in starts)):
                outs.append(out)
                logger.info(f"Upscaled slices {start}.."
                            f"{start + len(out) - 1}")
        sr = np.concatenate(outs, axis=0)
    # transpose_io outputs are (n, 2w, 2h): .T is the F-contiguous
    # (2h, 2w, n) volume with no copy
    sr_vol = sr.T if transposed else np.transpose(sr, (1, 2, 0))

    zooms = list(hdr.zooms) + [1.0] * 3
    out_zooms = (zooms[0] / 2.0, zooms[1] / 2.0, zooms[2])
    slope = unit_slope(sr_vol.dtype)
    nifti.save(output_path, sr_vol, zooms=out_zooms, scl_slope=slope)
    logger.info(f"Wrote {output_path}: {sr_vol.shape} {sr_vol.dtype} at "
                f"spacing {out_zooms}")

    if args.save_png_dir:
        from mri_superresolution_torch import native
        os.makedirs(args.save_png_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(input_path))[0]
        to_u8 = {np.dtype(np.uint8): lambda s: s,
                 np.dtype(np.int16): lambda s: np.round(
                     s * (255.0 / 32767.0)).astype(np.uint8)}
        conv = to_u8.get(sr.dtype,
                         lambda s: np.clip(s * 255, 0, 255).astype(np.uint8))
        for i in range(sr.shape[0]):
            plane = sr[i].T if transposed else sr[i]
            native.imwrite_gray(os.path.join(args.save_png_dir,
                                             f"{base}_s{i:03d}.png"),
                                np.ascontiguousarray(conv(plane)))
        logger.info(f"Wrote {sr.shape[0]} PNGs to {args.save_png_dir}")
    return 0


def _load_engine(args, device):
    """The engine the flags ask for, from the checkpoint they name."""
    from mri_superresolution_torch.config import InferConfig, ModelConfig
    from mri_superresolution_torch.infer import load_engine
    from mri_superresolution_torch.utils.device import pool_args
    return load_engine(
        InferConfig(model=ModelConfig(model_type=args.model_type,
                                      base_filters=args.base_filters),
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_path=args.checkpoint_path,
                    bf16=not args.no_bf16, bucket=args.bucket,
                    spatial_shards=args.spatial_shards, quant=args.quant,
                    quant_calib_slices=args.quant_calib_slices,
                    quant_calib_path=args.quant_calib, tta=args.tta,
                    normalize_inputs=args.serve_raw,
                    transpose_io=args.serve_raw and not args.tta,
                    out_dtype=args.out_dtype),
        device=device, **pool_args(args.num_devices, args.cpu))


def main(argv=None) -> int:
    args = parse_args(argv)

    from mri_superresolution_torch.utils.logging import setup_logging

    logger = setup_logging("inference.log")
    device = "cpu" if args.cpu else None
    engine = art = None
    if args.artifact:
        from mri_superresolution_torch.infer.export import load_artifact
        try:
            art = load_artifact(args.artifact, device=device)
        except Exception as e:  # the CLI boundary: report and exit 1
            logger.exception(f"Cannot load the artifact: {e}")
            return 1
        refused, ignored = artifact_conflicts(args, art)
        if refused:
            logger.error(
                f"--artifact is incompatible with {', '.join(refused)}; "
                "export those modes into the artifact (cli.export_serving "
                "--mode tta|int8, --serve_raw, --out_dtype) or serve from "
                "a checkpoint")
            return 1
        if ignored:
            logger.warning(f"{', '.join(ignored)} are IGNORED with "
                           "--artifact (programs run at their exported "
                           "shapes on one device)")
        logger.info(f"Serving from artifact {args.artifact}: "
                    f"{art.model_type} mode={art.mode}, shapes "
                    f"{art.shapes} on {art.device} (no model code loaded)")
    else:
        try:
            engine = _load_engine(args, device)
        except Exception as e:  # the CLI boundary: report and exit 1
            logger.exception(f"Cannot load the engine: {e}")
            return 1
    is_dir = os.path.isdir(args.input)
    inputs = [args.input]
    if is_dir:
        inputs = sorted(glob.glob(os.path.join(args.input, "*.nii"))
                        + glob.glob(os.path.join(args.input, "*.nii.gz")))
        if not inputs:
            logger.error(f"No .nii/.nii.gz volumes in {args.input}")
            return 1
        try:
            os.makedirs(args.output, exist_ok=True)
        except OSError as e:
            logger.error(f"Cannot create output directory "
                         f"{args.output}: {e}")
            return 1
        logger.info(f"Batch mode: {len(inputs)} volume(s) from "
                    f"{args.input} -> {args.output}/ (one loaded engine)")
    failed = 0
    for ip in inputs:
        if not is_dir:
            op = args.output
        else:
            base = os.path.basename(ip)
            stem, ext = ((base[:-7], ".nii.gz") if base.endswith(".nii.gz")
                         else (os.path.splitext(base)[0], ".nii"))
            op = os.path.join(args.output, stem + "_sr" + ext)
        try:
            failed += _serve_one(args, engine, logger, ip, op, art) != 0
        except Exception as e:
            # one corrupt or unreadable volume must not abort a directory
            # batch: count it failed and serve the rest
            logger.error(f"{ip}: {type(e).__name__}: {e}")
            failed += 1
            if not is_dir:
                return 1
    if args.quant != "none" and engine is not None:
        logger.info(engine.quant_summary())
    if failed:
        logger.error(f"{failed}/{len(inputs)} volume(s) failed")
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
