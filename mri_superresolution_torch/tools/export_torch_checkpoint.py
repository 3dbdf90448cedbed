"""Export a checkpoint to a reference-format ``.pth``.

    python -m mri_superresolution_torch.tools.export_torch_checkpoint \
        --ckpt checkpoints/best_model_unet.ckpt --out best_model_unet.pth

The port's copy of the JAX package's ``tools/export_torch_checkpoint.py``:
a ``.ckpt`` of either package (or a bare-params ``.msgpack``) becomes the
reference's checkpoint dict (scripts/train.py:410-418): ``epoch``,
``model_state_dict``, ``val_loss`` and ``val_ssim``. The port's unet
state_dict already carries the reference's key names
(``train/checkpoint.py``), so the weights are written as they load, fp32.
Only the ``unet`` family, the reference's one real model. Host only: no
device is touched. ``tools/convert_torch_checkpoint.py`` is the inverse.
"""

from __future__ import annotations

import argparse
from typing import Dict


def torch_checkpoint_dict(params, meta: Dict) -> Dict:
    """The reference checkpoint dict of a unet state_dict and its meta."""
    import torch

    return {
        "epoch": int(meta.get("epoch", 0)),
        "model_state_dict": {k: torch.as_tensor(v).detach().to(
            torch.float32).contiguous().clone() for k, v in params.items()},
        "val_loss": float(meta.get("val_loss", 0.0)),
        "val_ssim": float(meta.get("val_ssim", 0.0)),
    }


def export(ckpt_path: str, out: str) -> None:
    """Write ``out`` from the checkpoint at ``ckpt_path``; SystemExit for
    a family other than the unet."""
    import torch

    from mri_superresolution_torch.train.checkpoint import (load_params_any,
                                                           model_type_of)

    params, meta = load_params_any(ckpt_path)
    mt = model_type_of(meta)
    if mt != "unet":
        raise SystemExit(f"only the 'unet' family exists in the reference; "
                         f"checkpoint is {mt!r}")
    torch.save(torch_checkpoint_dict(params, meta), out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True,
                    help=".ckpt (either package) or bare-params .msgpack")
    ap.add_argument("--out", required=True, help="output .pth path")
    args = ap.parse_args(argv)
    export(args.ckpt, args.out)
    print(f"Wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
