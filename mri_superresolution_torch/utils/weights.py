"""Carry weights between the JAX package's param trees and this port.

One bijection for each model family and for VGG19, between the JAX
package's flax tree (nested dicts of numpy arrays; no JAX is needed to
read them) and the port's state_dict (fp32 CPU tensors). Conv kernels go
HWIO <-> OIHW, GroupNorm scale/bias <-> weight/bias, ``alpha`` () <-> (1,).
PixelShuffle channel order is the same in both packages, so no channel is
permuted.

- ``unet``: the reference PyTorch model's keys (models/unet_model.py:
  116-211), as the JAX package's own ``utils/torch_compat.py`` maps them;
- ``unet_tpu``: the unet's keys for the backbone, then ``branch_a_conv``,
  ``branch_a_norm``, ``branch_b_conv``, ``branch_b_norm``, ``head_conv``,
  ``head_norm``, ``head_out`` and ``alpha`` under their flax names;
- ``edsr``: ``head``, ``block{i}.conv0``/``conv1`` (flax ``block{i}/
  Conv_0``/``Conv_1``), ``body_out``, ``tail``;
- ``simple``: ``extract``, ``map``, ``reconstruct``;
- ``swinir`` (no JAX counterpart): the published state_dict names split at
  their dots into a nested tree, each tensor as it is (OIHW convs, (out,
  in) linears), so that the port's ``.ckpt`` carries it too;
- VGG19 (``vgg_state_dict_from_jax``): ``conv{i}`` <-> torchvision's
  ``features.{idx}`` at the i-th conv index.

A tree whose top-level keys do not fit the family raises ValueError. A
family's pair of functions and its top-level keys are its record in
``models/families``.
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


def _conv(node: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _oihw(node["kernel"])
    if "bias" in node:
        out[f"{prefix}.bias"] = _vec(node["bias"])


def _norm(node: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _vec(node["scale"])
    out[f"{prefix}.bias"] = _vec(node["bias"])


def _conv_inv(sd, prefix: str) -> dict:
    node = {"kernel": _hwio(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        node["bias"] = _np(sd[f"{prefix}.bias"])
    return node


def _norm_inv(sd, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


BACKBONE = ("inc", "down1", "down2", "down3", "up1", "up2", "up3")
UNET_TPU_HEAD = ("branch_a_conv", "branch_a_norm", "branch_b_conv",
                 "branch_b_norm", "head_conv", "head_norm", "head_out")
SIMPLE_LAYERS = ("extract", "map", "reconstruct")


def edsr_num_blocks(tree) -> int:
    """The residual blocks of an edsr param tree (flax names
    ``block{i}``) or state_dict (``block{i}.*`` keys)."""
    names = {k.split(".")[0] for k in tree if k.startswith("block")}
    return len(names)


def swinir_widths(sd) -> dict:
    """The ``ModelConfig`` fields of a swinir state_dict (published names),
    read from its shapes: ``in_channels``, ``out_channels``,
    ``base_filters`` (embed_dim), ``num_blocks`` (RSTBs), ``swin_depth``,
    ``swin_heads``, ``window_size``, ``mlp_ratio`` and ``num_feat``."""
    pre = "layers.0.residual_group.blocks"
    table = sd[f"{pre}.0.attn.relative_position_bias_table"]
    embed = sd["conv_first.weight"].shape[0]
    return {
        "in_channels": sd["conv_first.weight"].shape[1],
        "out_channels": sd["conv_last.weight"].shape[0],
        "base_filters": embed,
        "num_blocks": len({k.split(".")[1] for k in sd
                           if k.startswith("layers.")}),
        "swin_depth": len({k.split(".")[4] for k in sd
                           if k.startswith(pre + ".")}),
        "swin_heads": table.shape[1],
        "window_size": (round(table.shape[0] ** 0.5) + 1) // 2,
        "mlp_ratio": sd[f"{pre}.0.mlp.fc1.weight"].shape[0] / embed,
        "num_feat": sd["conv_before_upsample.0.weight"].shape[0]}


def check_tree(params: dict, model_type: str) -> None:
    """Raise ValueError unless the param tree's top-level keys are those of
    ``model_type``."""
    from mri_superresolution_torch.models.families import family
    want = family(model_type).jax_keys(params)
    got = set(params)
    if got != want:
        raise ValueError(
            f"the param tree does not fit model type {model_type!r}: "
            f"missing {sorted(want - got)}, unexpected {sorted(got - want)}")


def _backbone(params: dict, sd: Dict[str, torch.Tensor]) -> None:
    _double_conv(params["inc"], "inc.double_conv", sd)
    for i in (1, 2, 3):
        _double_conv(params[f"down{i}"]["conv"],
                     f"down{i}.maxpool_conv.1.double_conv", sd)
    for i in (1, 2, 3):
        up = params[f"up{i}"]
        sd[f"up{i}.up.1.weight"] = _oihw(up["up_conv"]["kernel"])
        _norm(up["up_norm"], f"up{i}.up.2", sd)
        _double_conv(up["conv"], f"up{i}.conv.double_conv", sd)


def _backbone_inv(sd, params: dict) -> None:
    params["inc"] = _double_conv_inv(sd, "inc.double_conv")
    for i in (1, 2, 3):
        params[f"down{i}"] = {"conv": _double_conv_inv(
            sd, f"down{i}.maxpool_conv.1.double_conv")}
    for i in (1, 2, 3):
        params[f"up{i}"] = {
            "up_conv": {"kernel": _hwio(sd[f"up{i}.up.1.weight"])},
            "up_norm": _norm_inv(sd, f"up{i}.up.2"),
            "conv": _double_conv_inv(sd, f"up{i}.conv.double_conv"),
        }


def unet_to_sd(params: dict, sd: Dict[str, torch.Tensor]) -> None:
    _backbone(params, sd)
    sd["alpha"] = _vec(params["alpha"]).reshape(1)
    sd["final_up_bilinear.1.weight"] = _oihw(params["final_up_conv"]["kernel"])
    _norm(params["final_up_norm"], "final_up_bilinear.2", sd)
    ps = params["final_up_pixelshuffle"]
    _conv(ps["conv"], "final_up_pixelshuffle.conv", sd)
    _norm(ps["norm"], "final_up_pixelshuffle.norm", sd)
    sd["final_conv.0.weight"] = _oihw(params["final_conv1"]["kernel"])
    _norm(params["final_norm"], "final_conv.1", sd)
    _conv(params["final_conv2"], "final_conv.3", sd)


def unet_from_sd(sd, params: dict) -> None:
    _backbone_inv(sd, params)
    params.update({
        "alpha": _np(sd["alpha"]).reshape(()),
        "final_up_conv": {"kernel": _hwio(sd["final_up_bilinear.1.weight"])},
        "final_up_norm": _norm_inv(sd, "final_up_bilinear.2"),
        "final_up_pixelshuffle": {
            "conv": _conv_inv(sd, "final_up_pixelshuffle.conv"),
            "norm": _norm_inv(sd, "final_up_pixelshuffle.norm")},
        "final_conv1": {"kernel": _hwio(sd["final_conv.0.weight"])},
        "final_norm": _norm_inv(sd, "final_conv.1"),
        "final_conv2": _conv_inv(sd, "final_conv.3"),
    })


def unet_tpu_to_sd(params: dict, sd: Dict[str, torch.Tensor]) -> None:
    _backbone(params, sd)
    for name in UNET_TPU_HEAD:
        (_norm if name.endswith("_norm") else _conv)(params[name], name, sd)
    sd["alpha"] = _vec(params["alpha"]).reshape(1)


def unet_tpu_from_sd(sd, params: dict) -> None:
    _backbone_inv(sd, params)
    for name in UNET_TPU_HEAD:
        params[name] = (_norm_inv if name.endswith("_norm") else _conv_inv)(
            sd, name)
    params["alpha"] = _np(sd["alpha"]).reshape(())


def edsr_to_sd(params: dict, sd: Dict[str, torch.Tensor]) -> None:
    _conv(params["head"], "head", sd)
    for i in range(edsr_num_blocks(params)):
        block = params[f"block{i}"]
        _conv(block["Conv_0"], f"block{i}.conv0", sd)
        _conv(block["Conv_1"], f"block{i}.conv1", sd)
    _conv(params["body_out"], "body_out", sd)
    _conv(params["tail"], "tail", sd)


def edsr_from_sd(sd, params: dict) -> None:
    params["head"] = _conv_inv(sd, "head")
    for i in range(edsr_num_blocks(sd)):
        params[f"block{i}"] = {"Conv_0": _conv_inv(sd, f"block{i}.conv0"),
                               "Conv_1": _conv_inv(sd, f"block{i}.conv1")}
    params["body_out"] = _conv_inv(sd, "body_out")
    params["tail"] = _conv_inv(sd, "tail")


def simple_to_sd(params: dict, sd: Dict[str, torch.Tensor]) -> None:
    for name in SIMPLE_LAYERS:
        _conv(params[name], name, sd)


def simple_from_sd(sd, params: dict) -> None:
    for name in SIMPLE_LAYERS:
        params[name] = _conv_inv(sd, name)


def nested_to_sd(params: dict, sd: Dict[str, torch.Tensor],
                 prefix="") -> None:
    for k, v in params.items():
        if isinstance(v, dict):
            nested_to_sd(v, sd, f"{prefix}{k}.")
        else:
            sd[prefix + k] = torch.from_numpy(np.array(v, np.float32,
                                                       copy=True))


def nested_from_sd(sd, params: dict) -> None:
    for k, v in sd.items():
        *path, leaf = k.split(".")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _np(v)


def state_dict_from_jax(params: dict, model_type: str = "unet"
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's param tree of ``model_type`` (nested numpy
    arrays) -> this port's state_dict (fp32 CPU tensors). Raises
    ValueError when the tree is not one of that family."""
    from mri_superresolution_torch.models.families import family
    check_tree(params, model_type)
    sd: Dict[str, torch.Tensor] = {}
    family(model_type).to_sd(params, sd)
    return sd


def _double_conv_inv(sd, prefix: str) -> dict:
    return {
        "conv1": {"kernel": _hwio(sd[f"{prefix}.0.weight"])},
        "norm1": _norm_inv(sd, f"{prefix}.1"),
        "conv2": {"kernel": _hwio(sd[f"{prefix}.3.weight"])},
        "norm2": _norm_inv(sd, f"{prefix}.4"),
    }


def jax_params_from_state_dict(sd, model_type: str = "unet") -> dict:
    """Inverse of :func:`state_dict_from_jax`: a port state_dict of
    ``model_type`` (for the unet, a reference one too) -> the JAX
    package's param tree of numpy arrays."""
    from mri_superresolution_torch.models.families import family
    params: dict = {}
    family(model_type).from_sd(sd, params)
    return params


def vgg_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG19 tree (``conv{i}``: HWIO kernel, bias) ->
    the state_dict of ``models.vgg.VGG19Features`` (torchvision's
    ``features.{idx}`` keys at the i-th conv index)."""
    from mri_superresolution_torch.models.vgg import conv_indices
    idx = conv_indices()
    n = len(params)
    if set(params) != {f"conv{i}" for i in range(n)} or n > len(idx):
        raise ValueError(f"not a VGG19 param tree: {sorted(params)}")
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n):
        _conv(params[f"conv{i}"], f"features.{idx[i]}", sd)
    return sd


def vgg_params_from_state_dict(sd) -> dict:
    """Inverse of :func:`vgg_state_dict_from_jax`."""
    from mri_superresolution_torch.models.vgg import conv_indices
    idx = [i for i in conv_indices() if f"features.{i}.weight" in sd]
    return {f"conv{ci}": _conv_inv(sd, f"features.{i}")
            for ci, i in enumerate(idx)}
