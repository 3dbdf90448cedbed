"""L2-cold device time of kernel B2 (``ssim_per_sample``) at batch shapes.

    python mri_superresolution_torch/tools/ssim_time.py [--tree DIR]
        [--shapes 1x512x512 8x512x512 16x512x512]

Imports ``mri_superresolution_torch`` from DIR (default: the checkout this
file sits in), so that an older commit unpacked in DIR is timed by this
script beside the current one in the same call (``chip_smoke.py
--parent DIR`` does that). The pair of images at each shape is made on the
card from seed 0; each time is the median over CUDA graph replays of 20
calls on copies that together hold more than twice the card's L2
(``utils/timing.cuda_ms_cold``). Prints one JSON line: the tree, the card,
``ms`` by shape, and the first image's SSIM by shape. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

DEFAULT_SHAPES = ("1x512x512", "8x512x512", "16x512x512")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES))
    args = ap.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch
    from mri_superresolution_torch.kernels.ssim import ssim_per_sample
    from mri_superresolution_torch.utils.timing import (cuda_ms_cold,
                                                        l2_cold_copies)
    if not torch.cuda.is_available():
        print("ssim_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    ms, value = {}, {}
    for text in args.shapes:
        shape = tuple(int(v) for v in text.split("x"))
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.rand(shape, generator=gen, device=dev)
        b = (a + 0.05 * torch.randn(shape, generator=gen, device=dev)).clamp(
            0, 1)
        value[text] = float(ssim_per_sample(a, b)[0])
        pairs = l2_cold_copies(torch.stack([a, b]))
        ms[text] = cuda_ms_cold(lambda t: ssim_per_sample(t[0], t[1]), pairs)
        del pairs
    print(json.dumps({"tree": tree, "device": torch.cuda.get_device_name(0),
                      "ms": ms, "ssim": value}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
