"""Carry unet weights between the JAX package's param tree and this port.

The port's state_dict keys are the reference PyTorch model's (models/
unet_model.py:116-211), so the JAX tree maps onto them as the JAX package's
own ``utils/torch_compat.py`` maps it: conv kernels HWIO <-> OIHW,
GroupNorm scale/bias <-> weight/bias, ``alpha`` () <-> (1,). PixelShuffle
channel order is the same in both, so no channel permute is needed. The
mapping is a bijection. Trees here are nested dicts of numpy arrays; no JAX
is needed to read them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.array(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)),
        order="C", copy=True))


def _hwio(weight: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(weight), (2, 3, 1, 0)))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32, copy=True))


def _double_conv(tree: dict, prefix: str, out: Dict[str, torch.Tensor]):
    # reference Sequential indices: 0 conv, 1 GN, 3 conv, 4 GN
    out[f"{prefix}.0.weight"] = _oihw(tree["conv1"]["kernel"])
    out[f"{prefix}.1.weight"] = _vec(tree["norm1"]["scale"])
    out[f"{prefix}.1.bias"] = _vec(tree["norm1"]["bias"])
    out[f"{prefix}.3.weight"] = _oihw(tree["conv2"]["kernel"])
    out[f"{prefix}.4.weight"] = _vec(tree["norm2"]["scale"])
    out[f"{prefix}.4.bias"] = _vec(tree["norm2"]["bias"])


def state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's unet param tree (nested numpy arrays) -> this
    port's state_dict (fp32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    _double_conv(params["inc"], "inc.double_conv", sd)
    sd["alpha"] = _vec(params["alpha"]).reshape(1)
    sd["final_up_bilinear.1.weight"] = _oihw(params["final_up_conv"]["kernel"])
    sd["final_up_bilinear.2.weight"] = _vec(params["final_up_norm"]["scale"])
    sd["final_up_bilinear.2.bias"] = _vec(params["final_up_norm"]["bias"])
    ps = params["final_up_pixelshuffle"]
    sd["final_up_pixelshuffle.conv.weight"] = _oihw(ps["conv"]["kernel"])
    sd["final_up_pixelshuffle.conv.bias"] = _vec(ps["conv"]["bias"])
    sd["final_up_pixelshuffle.norm.weight"] = _vec(ps["norm"]["scale"])
    sd["final_up_pixelshuffle.norm.bias"] = _vec(ps["norm"]["bias"])
    sd["final_conv.0.weight"] = _oihw(params["final_conv1"]["kernel"])
    sd["final_conv.1.weight"] = _vec(params["final_norm"]["scale"])
    sd["final_conv.1.bias"] = _vec(params["final_norm"]["bias"])
    sd["final_conv.3.weight"] = _oihw(params["final_conv2"]["kernel"])
    sd["final_conv.3.bias"] = _vec(params["final_conv2"]["bias"])
    for i in (1, 2, 3):
        _double_conv(params[f"down{i}"]["conv"],
                     f"down{i}.maxpool_conv.1.double_conv", sd)
    for i in (1, 2, 3):
        up = params[f"up{i}"]
        sd[f"up{i}.up.1.weight"] = _oihw(up["up_conv"]["kernel"])
        sd[f"up{i}.up.2.weight"] = _vec(up["up_norm"]["scale"])
        sd[f"up{i}.up.2.bias"] = _vec(up["up_norm"]["bias"])
        _double_conv(up["conv"], f"up{i}.conv.double_conv", sd)
    return sd


def _double_conv_inv(sd, prefix: str) -> dict:
    return {
        "conv1": {"kernel": _hwio(sd[f"{prefix}.0.weight"])},
        "norm1": {"scale": _np(sd[f"{prefix}.1.weight"]),
                  "bias": _np(sd[f"{prefix}.1.bias"])},
        "conv2": {"kernel": _hwio(sd[f"{prefix}.3.weight"])},
        "norm2": {"scale": _np(sd[f"{prefix}.4.weight"]),
                  "bias": _np(sd[f"{prefix}.4.bias"])},
    }


def jax_params_from_state_dict(sd) -> dict:
    """Inverse of :func:`state_dict_from_jax`: a port (or reference)
    state_dict -> the JAX package's unet param tree of numpy arrays."""
    params = {
        "inc": _double_conv_inv(sd, "inc.double_conv"),
        "alpha": _np(sd["alpha"]).reshape(()),
        "final_up_conv": {"kernel": _hwio(sd["final_up_bilinear.1.weight"])},
        "final_up_norm": {"scale": _np(sd["final_up_bilinear.2.weight"]),
                          "bias": _np(sd["final_up_bilinear.2.bias"])},
        "final_up_pixelshuffle": {
            "conv": {"kernel": _hwio(sd["final_up_pixelshuffle.conv.weight"]),
                     "bias": _np(sd["final_up_pixelshuffle.conv.bias"])},
            "norm": {"scale": _np(sd["final_up_pixelshuffle.norm.weight"]),
                     "bias": _np(sd["final_up_pixelshuffle.norm.bias"])},
        },
        "final_conv1": {"kernel": _hwio(sd["final_conv.0.weight"])},
        "final_norm": {"scale": _np(sd["final_conv.1.weight"]),
                       "bias": _np(sd["final_conv.1.bias"])},
        "final_conv2": {"kernel": _hwio(sd["final_conv.3.weight"]),
                        "bias": _np(sd["final_conv.3.bias"])},
    }
    for i in (1, 2, 3):
        params[f"down{i}"] = {
            "conv": _double_conv_inv(sd, f"down{i}.maxpool_conv.1.double_conv")}
    for i in (1, 2, 3):
        params[f"up{i}"] = {
            "up_conv": {"kernel": _hwio(sd[f"up{i}.up.1.weight"])},
            "up_norm": {"scale": _np(sd[f"up{i}.up.2.weight"]),
                        "bias": _np(sd[f"up{i}.up.2.bias"])},
            "conv": _double_conv_inv(sd, f"up{i}.conv.double_conv"),
        }
    return params
