"""The serving daemon on the GPU: a dynamic-batching HTTP server.

    python -m mri_superresolution_torch.cli.serve --checkpoint_dir ckpt \
        [--port 8476] [--quant int8] [--serve_raw --out_dtype int16] [--cpu]

    POST /upscale         .npy (H, W) or (N, H, W) in [0, 1] -> .npy 2x
    POST /upscale_volume  .nii / .nii.gz -> the 2x-in-plane volume
    GET  /healthz         backend and batching stats (JSON)
    GET  /metrics         stats, queue depth, batch sizes, int8 routing,
                          limits (JSON)

Takes the flags of the JAX package's ``scripts/serve.py``, plus ``--cpu``.
Concurrent clients' slices coalesce into batched forwards of one
``InferenceEngine`` (``infer/server.py``), on the card unless ``--cpu``.
With ``--serve_raw`` the engine normalizes on the card and takes the
NIfTI layout: /upscale reads a posted (W, H) array as the transpose of
the (H, W) image it upscales and returns (2W, 2H), the transpose of the
output (``infer/server.serve_http``). SIGTERM or SIGINT stops the
server: it stops accepting, finishes the requests in flight, then closes
the batcher, and exits 0. ``--artifact`` serves a portable artifact
(``cli/export_serving.py``) with no model code, under the JAX CLI's
policy: a flag the artifact exports is satisfied, one it cannot serve
(``--quant``, ``--tta``, ``--serve_raw``, ``--out_dtype`` it does not
export, a ``--spatial_shards`` other than its own, ``--num_devices``)
exits 1, and ``--bucket`` is named as ignored. ``--num_devices``
(default 0: every visible GPU; with ``--cpu`` that many CPU devices,
0 = 1) spreads each coalesced batch over a copy of the model on each
device (``InferenceEngine``'s device pool). ``--spatial_shards S`` > 1
splits each slice's rows over S of them (``parallel/spatial.py``), the
batch over the device count / S data groups, as the JAX CLI does; the
device slots may then outnumber the cards, which are named in turn.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def parse_args(argv=None):
    from mri_superresolution_torch.models.families import model_flags
    ap = argparse.ArgumentParser(
        description="Dynamic-batching HTTP inference server",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="With --serve_raw, POST /upscale takes the NIfTI layout: "
               "a posted (W, H) .npy is read as the transpose of the "
               "(H, W) image it upscales (the C-order view of a NIfTI "
               "volume's F-order slice), and the response is (2W, 2H), "
               "the transpose of that image's (2H, 2W) output. Post an "
               "image's transpose and transpose the response.")
    ap.add_argument("--checkpoint_dir", default="./checkpoints")
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--artifact", default=None,
                    help="serve a portable artifact (cli.export_serving) "
                         "instead of a checkpoint")
    fill = model_flags(ap, base_filters=32)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--max_batch", type=int, default=64,
                    help="largest coalesced device batch")
    ap.add_argument("--batch_window_ms", type=float, default=5.0,
                    help="linger this long after the first request for "
                         "others to coalesce")
    ap.add_argument("--bucket", type=int, default=1)
    ap.add_argument("--spatial_shards", type=int, default=1,
                    help="split each slice's rows over this many devices "
                         "(must divide the device count, --num_devices)")
    ap.add_argument("--quant", choices=["none", "int8"], default="none")
    ap.add_argument("--quant_calib", default=None,
                    help="JSON sidecar of frozen int8 scales (a QAT "
                         "checkpoint's <base>.calib.json is found without "
                         "it)")
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--num_devices", type=int, default=0,
                    help="devices a batch is split over (0 = every "
                         "visible GPU; with --cpu, CPU devices, 0 = 1)")
    ap.add_argument("--serve_raw", action="store_true",
                    help="the engine normalizes on the card: "
                         "/upscale_volume submits the stored voxels, and "
                         "/upscale takes native-dtype arrays in the "
                         "transposed (W, H) layout (see below). Not with "
                         "--quant int8")
    ap.add_argument("--out_dtype", default="float32",
                    choices=["float32", "int16", "uint8"],
                    help="pack outputs on the card to this dtype (volume "
                         "responses carry the NIfTI scl_slope that decodes "
                         "them to [0,1])")
    ap.add_argument("--max_pending", type=int, default=2048,
                    help="bounded request queue: submissions beyond this "
                         "get 503 + Retry-After")
    ap.add_argument("--max_body_mb", type=int, default=512,
                    help="request bodies over this size get 413")
    ap.add_argument("--request_timeout_s", type=float, default=300.0,
                    help="requests unserved after this long get 504 and "
                         "are abandoned (never run on the device)")
    ap.add_argument("--no_bf16", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="Run on the CPU instead of the GPU")
    return fill(ap.parse_args(argv))


def artifact_conflicts(args, art) -> list:
    """The flags a loaded artifact cannot serve: a mode it exports is
    satisfied, anything else is refused (the JAX CLI's policy)."""
    import numpy as np
    return [name for name, on in (
        ("--quant", args.quant != "none" and art.mode != "int8"),
        ("--tta", args.tta and art.mode != "tta"),
        ("--spatial_shards", args.spatial_shards != 1
         and (art.spatial or {}).get("n_space") != args.spatial_shards),
        ("--num_devices", args.num_devices != 0),
        ("--serve_raw", args.serve_raw and not art.normalize_inputs),
        ("--out_dtype", args.out_dtype != "float32"
         and np.dtype(args.out_dtype) != art.out_dtype)) if on]


def _backend(args, logger):
    """(backend, description) for the flags, or (None, None) after a
    logged refusal."""
    device = "cpu" if args.cpu else None
    if args.artifact:
        import os
        from mri_superresolution_torch.infer.export import load_artifact
        art = load_artifact(args.artifact, device=device)
        bad = artifact_conflicts(args, art)
        if bad:
            logger.error(
                f"--artifact is incompatible with {', '.join(bad)}; "
                "export those modes into the artifact (cli.export_serving "
                "--mode tta|int8, --serve_raw, --out_dtype) or serve from "
                "a checkpoint")
            return None, None
        if args.bucket != 1:
            logger.warning("--bucket is IGNORED with --artifact (programs "
                           "run at their exported shapes)")
        describe = (f"artifact {os.path.basename(args.artifact)} "
                    f"{art.model_type} mode={art.mode} shapes={art.shapes} "
                    f"raw={art.normalize_inputs} out={art.out_dtype} "
                    f"device={art.device}")
        logger.info(f"Serving from artifact: {describe}")
        return art, describe
    from mri_superresolution_torch.config import InferConfig, ModelConfig
    from mri_superresolution_torch.infer import load_engine
    from mri_superresolution_torch.utils.device import pool_args
    engine = load_engine(InferConfig(
        model=ModelConfig(model_type=args.model_type,
                          base_filters=args.base_filters),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_path=args.checkpoint_path,
        bf16=not args.no_bf16, bucket=args.bucket,
        spatial_shards=args.spatial_shards,
        quant=args.quant, quant_calib_path=args.quant_calib, tta=args.tta,
        normalize_inputs=args.serve_raw,
        # the ensemble's transforms are defined on (N, h, w): raw TTA
        # normalizes on the card in the standard layout
        transpose_io=args.serve_raw and not args.tta,
        out_dtype=args.out_dtype), device=device,
        **pool_args(args.num_devices, args.cpu))
    return engine, (f"checkpoint {engine.model_cfg.model_type} "
                    f"bf={engine.model_cfg.base_filters} "
                    f"quant={args.quant} tta={args.tta} "
                    f"raw={args.serve_raw} out={args.out_dtype} "
                    f"device={engine.device} devices={engine.n_devices}"
                    f" spatial={engine.spatial_shards}")


def main(argv=None) -> int:
    args = parse_args(argv)

    from mri_superresolution_torch.infer.server import serve_http
    from mri_superresolution_torch.utils.logging import setup_logging

    logger = setup_logging("serving.log")
    backend, describe = _backend(args, logger)
    if backend is None:
        return 1
    server = serve_http(backend, host=args.host, port=args.port,
                        max_batch=args.max_batch,
                        batch_window_ms=args.batch_window_ms,
                        describe=describe, max_pending=args.max_pending,
                        max_body_bytes=args.max_body_mb << 20,
                        request_timeout_s=args.request_timeout_s)

    def _stop(signum, frame):
        logger.info(f"Signal {signum}; draining and shutting down")
        # shutdown() waits for serve_forever, which runs on this thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
    finally:
        # join the handler threads in flight before the batcher closes,
        # so that every accepted request is served
        server.server_close()
        server.batcher.close()
        logger.info("Server stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
