"""Convert torchvision's VGG19 ImageNet weights, from a local ``.pth``, to
the ``.npz`` the perceptual loss reads (``models/vgg.py``).

    python -m mri_superresolution_torch.tools.fetch_vgg_weights \
        --pth vgg19-dcbb9e9d.pth --out vgg19_imagenet.npz
    # then: cli.train --perceptual_weight 0.1 --vgg_weights vgg19_imagenet.npz

The ``--pth`` conversion of the JAX package's ``tools/fetch_vgg_weights.py``:
the state_dict's ``features.*`` keys up to ``--feature_layer_idx`` (35,
the perceptual loss's layer) as the VGG19 param tree. It downloads
nothing: fetch the file from ``VGG19_URL`` on a machine with network
access first. Without ``--pth`` it exits non-zero, naming that URL.
"""

from __future__ import annotations

import argparse
import sys

VGG19_URL = "https://download.pytorch.org/models/vgg19-dcbb9e9d.pth"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Convert a local torchvision "
                                 "VGG19 .pth to the perceptual loss's .npz")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--pth", default=None,
                    help=f"a downloaded torchvision vgg19 .pth ({VGG19_URL})")
    ap.add_argument("--feature_layer_idx", type=int, default=35)
    args = ap.parse_args(argv)
    if not args.pth:
        print(f"fetch_vgg_weights: --pth is required: download "
              f"{VGG19_URL} on a machine with network access and pass the "
              f"file; nothing is downloaded here", file=sys.stderr)
        return 2

    import torch

    from mri_superresolution_torch.models.vgg import (
        params_from_torch_state_dict, save_params_npz)

    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in sd.items() if k.startswith("features.")}
    params = params_from_torch_state_dict(sd, args.feature_layer_idx)
    save_params_npz(args.out, params)
    print(f"Wrote {args.out} ({len(params)} conv layers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
