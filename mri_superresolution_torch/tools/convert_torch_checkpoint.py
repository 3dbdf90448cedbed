"""Convert a reference ``.pth`` to a checkpoint of the JAX package's
format.

    python -m mri_superresolution_torch.tools.convert_torch_checkpoint \
        --pth best_model_unet.pth --out best_model_unet.ckpt

The port's counterpart of the JAX package's
``tools/convert_torch_checkpoint.py``, the inverse of
``tools/export_torch_checkpoint.py``: a reference ``UNetSuperRes``
checkpoint (its full dict or a bare state_dict) becomes a ``.ckpt`` with
its JSON sidecar (``train/checkpoint.save_checkpoint``), which both
packages serve; the ``.pth``'s epoch, val_loss and val_ssim go into the
sidecar. An ``--out`` ending in ``.msgpack`` writes the bare flax param
tree instead, as the JAX tool does. Only the ``unet`` family. Host only:
no device is touched.
"""

from __future__ import annotations

import argparse


def convert(pth: str, out: str) -> None:
    import torch

    from mri_superresolution_torch.train import checkpoint as ckpt
    from mri_superresolution_torch.utils.weights import (
        jax_params_from_state_dict)

    params, _ = ckpt.load_params_any(pth)
    if out.endswith(".msgpack"):
        with open(out, "wb") as f:
            f.write(ckpt.msgpack_serialize(
                jax_params_from_state_dict(params, "unet")))
        return
    blob = torch.load(pth, map_location="cpu", weights_only=True)
    meta = {"config": {"model": {"model_type": "unet"}}}
    if isinstance(blob, dict) and "model_state_dict" in blob:
        meta.update({k: blob[k] for k in ("epoch", "val_loss", "val_ssim")
                     if k in blob})
    ckpt.save_checkpoint(out, params, meta=meta, model_type="unet")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True,
                    help="output .ckpt (with its .json sidecar) or "
                         ".msgpack")
    args = ap.parse_args(argv)
    convert(args.pth, args.out)
    print(f"Wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
