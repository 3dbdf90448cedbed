"""VGG19 feature extractor for the perceptual loss.

An own port of the JAX package's ``models/vgg.py`` (the role of
torchvision's ``vgg19(...).features`` in the reference, utils/losses.py:
83-118): grayscale inputs are replicated to 3 channels, normalized with
the ImageNet mean/std in the compute dtype, and run through the conv/ReLU/
maxpool stack up to ``feature_layer_idx`` inclusive (torch Sequential
index semantics: 35 is relu5_4).

``VGG19Features`` holds the stack as torchvision's ``features.{idx}``
layout, so a torchvision state_dict loads into it. Weights travel as the
JAX package's param tree (``conv{i}``: HWIO ``kernel``, ``bias``; numpy),
and ``.npz`` files keep its format (``conv{i}/kernel``, ``conv{i}/bias``),
so each package reads the other's files. ``random_params`` draws He-normal
kernels and zero biases from an explicit ``torch.Generator``; its draws are
not ``jax.random``'s. The convolutions are cuDNN's (``nn.Conv2d``), in fp32
by default as in the JAX package; on the card they follow
``torch.backends.cudnn.allow_tf32`` (PyTorch's default True: TF32), which
this module does not set.

The layer loop is the one copy of the VGG19 stack: its hooks
(``conv_fn``, ``pool_fn`` and ``each``, the JAX function's
``conv_fn``/``pool_fn``) let the row-sharded loss run it on row blocks
(``parallel/spatial.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)

# torchvision VGG19 'E' configuration; 'M' = 2x2 maxpool stride 2.
_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def layer_table() -> List[Tuple[str, int]]:
    """(kind, arg) per torch Sequential index: ('conv', out_ch) / ('relu', 0)
    / ('pool', 0). VGG19 features has 37 entries; index 35 is relu5_4."""
    table: List[Tuple[str, int]] = []
    for v in _CFG:
        if v == "M":
            table.append(("pool", 0))
        else:
            table.append(("conv", int(v)))
            table.append(("relu", 0))
    return table


def conv_indices() -> List[int]:
    return [i for i, (k, _) in enumerate(layer_table()) if k == "conv"]


def n_pools(feature_layer_idx: int) -> int:
    """Number of 2x2 maxpools crossed by ``extract_features`` up to (and
    including) ``feature_layer_idx``."""
    return sum(1 for i, (kind, _) in enumerate(layer_table())
               if i <= feature_layer_idx and kind == "pool")


def random_params(generator: torch.Generator,
                  feature_layer_idx: int = 35) -> Dict:
    """He-normal random VGG weights (the offline fallback), the convs up to
    ``feature_layer_idx``: kernel ~ N(0, 2 / fan_in) in HWIO, zero bias,
    drawn from ``generator`` in layer order."""
    params: Dict = {}
    in_ch = 3
    ci = 0
    for i, (kind, arg) in enumerate(layer_table()):
        if i > feature_layer_idx:
            break
        if kind == "conv":
            kern = torch.randn((3, 3, in_ch, arg), generator=generator,
                               dtype=torch.float32)
            kern = kern * np.sqrt(2.0 / (in_ch * 9))
            params[f"conv{ci}"] = {"kernel": kern.numpy(),
                                   "bias": np.zeros((arg,), np.float32)}
            in_ch = arg
            ci += 1
    return params


def params_from_torch_state_dict(sd: Dict, feature_layer_idx: int = 35
                                 ) -> Dict:
    """Convert torchvision ``vgg19().features`` keys (``features.{i}.weight``
    or bare ``{i}.weight``, tensors or arrays) to the param tree."""
    out: Dict = {}
    ci = 0
    for idx in conv_indices():
        if idx > feature_layer_idx:
            break
        for pref in (f"features.{idx}", str(idx)):
            wk, bk = f"{pref}.weight", f"{pref}.bias"
            if wk in sd:
                w = np.asarray(sd[wk], np.float32)
                out[f"conv{ci}"] = {
                    "kernel": np.ascontiguousarray(
                        np.transpose(w, (2, 3, 1, 0))),
                    "bias": np.asarray(sd[bk], np.float32).copy(),
                }
                break
        else:
            raise KeyError(f"missing conv weight for features index {idx}")
        ci += 1
    return out


def load_params_npz(path: str) -> Dict:
    with np.load(path) as data:
        params: Dict = {}
        for name in data.files:
            layer, leaf = name.split("/")
            params.setdefault(layer, {})[leaf] = data[name]
    return params


def save_params_npz(path: str, params: Dict) -> None:
    flat = {f"{layer}/{leaf}": np.asarray(v)
            for layer, leaves in params.items() for leaf, v in leaves.items()}
    np.savez(path, **flat)


class VGG19Features(nn.Module):
    """torchvision's ``vgg19().features`` up to ``feature_layer_idx``
    inclusive, frozen (no parameter requires a gradient)."""

    def __init__(self, feature_layer_idx: int = 35):
        super().__init__()
        self.feature_layer_idx = feature_layer_idx
        layers: List[nn.Module] = []
        in_ch = 3
        for i, (kind, arg) in enumerate(layer_table()):
            if i > feature_layer_idx:
                break
            if kind == "conv":
                layers.append(nn.Conv2d(in_ch, arg, 3, padding=1))
                in_ch = arg
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2))
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    @classmethod
    def from_params(cls, params: Dict, feature_layer_idx: int = 35
                    ) -> "VGG19Features":
        """The stack with the param tree's weights (its convs up to
        ``feature_layer_idx``; a tree with more convs is cut)."""
        from mri_superresolution_torch.utils.weights import (
            vgg_state_dict_from_jax)
        m = cls(feature_layer_idx)
        n = sum(1 for i in conv_indices() if i <= feature_layer_idx)
        m.load_state_dict(vgg_state_dict_from_jax(
            {f"conv{i}": params[f"conv{i}"] for i in range(n)}))
        return m

    def forward(self, x, dtype=torch.float32, conv_fn=None, pool_fn=None,
                each=None):
        """(B, H, W, C) images in [0, 1] -> (B, h, w, channels) features of
        the last layer, in ``dtype`` (the JAX package's layout).

        ``conv_fn(x, weight, bias)`` and ``pool_fn(x)`` replace the padded
        3x3 conv and the 2x2 maxpool, and ``each(fn, x)`` applies every
        other step (the input's normalization, the ReLUs, the output's
        layout) to ``x``; the row-sharded loss passes its haloed conv,
        its local pool and its group's ``map`` over a list of row
        blocks."""
        each = each or _call

        def prepare(t):
            if t.shape[-1] == 1:
                t = t.expand(*t.shape[:-1], 3)
            mean = torch.tensor(VGG_MEAN, dtype=dtype, device=t.device)
            std = torch.tensor(VGG_STD, dtype=dtype, device=t.device)
            t = ((t.to(dtype) - mean) / std).permute(0, 3, 1, 2)
            return t.contiguous(memory_format=torch.channels_last)

        x = each(prepare, x)
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                w, b = layer.weight.to(dtype), layer.bias.to(dtype)
                x = (each(lambda t: F.conv2d(t, w, b, padding=1), x)
                     if conv_fn is None else conv_fn(x, w, b))
            elif isinstance(layer, nn.MaxPool2d) and pool_fn is not None:
                x = pool_fn(x)
            else:
                x = each(layer, x)
        return each(lambda t: t.permute(0, 2, 3, 1), x)


def _call(fn, *args):
    return fn(*args)


def extract_features(vgg: VGG19Features, x: torch.Tensor,
                     dtype=torch.float32, conv_fn=None, pool_fn=None,
                     each=None) -> torch.Tensor:
    """Run NHWC images in [0, 1] through ``vgg`` up to its
    ``feature_layer_idx`` (the JAX package's ``extract_features``, its
    hooks included: see :meth:`VGG19Features.forward`)."""
    return vgg(x, dtype, conv_fn, pool_fn, each)
