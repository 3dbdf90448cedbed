"""The model families of the port, in one table.

A family is a ``ModelConfig.model_type``. Its :class:`Family` record holds
what modules outside its model code need of it, so the registry, the
CLIs, checkpoints, the engine, the trainer and export ask :data:`FAMILIES`
and name no family. A new family is its model module, one entry here,
its JAX mapping in ``utils/weights`` if the nested one does not fit, and
its tests. The int8 and row-sharded forwards (``models/quant_forward``,
``parallel/spatial``) keep their own tables: they are implementations.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Tuple

from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.models.edsr import EDSR
from mri_superresolution_torch.models.simple import SimpleSR
from mri_superresolution_torch.models.swinir import SwinIR
from mri_superresolution_torch.models.unet import UNetSuperRes
from mri_superresolution_torch.models.unet_tpu import UNetSuperResTPU
from mri_superresolution_torch.utils import weights


@dataclass(frozen=True)
class Family:
    name: str
    build: Callable     # (cfg, dtype, generator, remat) -> seeded nn.Module
    to_sd: Callable     # (JAX param tree, state_dict to fill)
    from_sd: Callable   # (state_dict, JAX param tree to fill)
    jax_keys: Callable  # a JAX param tree -> the top-level keys it must have
    widths: Callable = lambda sd: {}   # the ModelConfig fields sd's shapes fix
    # the CLIs' --base_filters / --num_blocks when none is given, and what
    # those flags mean for the family (their help)
    cli_widths: Mapping[str, int] = field(default_factory=dict)
    flag_help: Mapping[str, str] = field(default_factory=dict)
    jax: bool = True        # the JAX package has the family
    exports: bool = True    # torch.export records its served forward
    # key suffixes of a published file's buffers, which the port derives
    published_buffers: Tuple[str, ...] = ()


def _conv_net(cls, **fields):
    """A conv family's build: ``cls`` at the config's channels and
    base_filters, and ``fields`` (keyword -> ModelConfig field)."""
    return lambda cfg, dtype, generator, remat: cls(
        in_channels=cfg.in_channels, out_channels=cfg.out_channels,
        base_filters=cfg.base_filters, dtype=dtype, generator=generator,
        remat=remat, **{k: getattr(cfg, f) for k, f in fields.items()})


def _swinir(cfg, dtype, generator, remat):  # nothing to remat
    return SwinIR(in_channels=cfg.in_channels, out_channels=cfg.out_channels,
                  embed_dim=cfg.base_filters, num_layers=cfg.num_blocks,
                  depth=cfg.swin_depth, heads=cfg.swin_heads,
                  window=cfg.window_size, mlp_ratio=cfg.mlp_ratio,
                  num_feat=cfg.num_feat, dtype=dtype, generator=generator)


# in the CLIs' order
FAMILIES: Dict[str, Family] = {f.name: f for f in (
    Family("unet", _conv_net(UNetSuperRes, initial_alpha="initial_alpha"),
           weights.unet_to_sd, weights.unet_from_sd,
           lambda tree: {*weights.BACKBONE, "final_up_conv", "final_up_norm",
                         "final_up_pixelshuffle", "final_conv1",
                         "final_norm", "final_conv2", "alpha"}),
    Family("unet_tpu",
           _conv_net(UNetSuperResTPU, initial_alpha="initial_alpha"),
           weights.unet_tpu_to_sd, weights.unet_tpu_from_sd,
           lambda tree: {*weights.BACKBONE, *weights.UNET_TPU_HEAD, "alpha"}),
    Family("edsr", _conv_net(EDSR, num_blocks="num_blocks"),
           weights.edsr_to_sd, weights.edsr_from_sd,
           lambda tree: {"head", "body_out", "tail"} | {
               f"block{i}" for i in range(weights.edsr_num_blocks(tree))},
           widths=lambda sd: {"num_blocks": weights.edsr_num_blocks(sd)},
           flag_help={"num_blocks": "residual trunk depth"}),
    Family("simple", _conv_net(SimpleSR), weights.simple_to_sd,
           weights.simple_from_sd, lambda tree: set(weights.SIMPLE_LAYERS)),
    Family("swinir", _swinir, weights.nested_to_sd, weights.nested_from_sd,
           lambda tree: {"conv_first", "patch_embed", "layers", "norm",
                         "conv_after_body", "conv_before_upsample",
                         "upsample", "conv_last"},
           widths=weights.swinir_widths,
           cli_widths={"base_filters": 180, "num_blocks": 6},
           flag_help={"base_filters": "its embed_dim",
                      "num_blocks": "residual Swin groups"},
           jax=False, exports=False,
           published_buffers=(".relative_position_index", ".attn_mask")),
)}


def family(name: str) -> Family:
    if name not in FAMILIES:
        raise ValueError(f"Unknown model type: {name} "
                         f"(have {sorted(FAMILIES)})")
    return FAMILIES[name]


def jax_families():
    return [n for n, f in FAMILIES.items() if f.jax]


def with_weight_widths(cfg: ModelConfig, params) -> Tuple[ModelConfig, dict]:
    """``cfg`` with the fields that the state_dict ``params`` fixes in its
    shapes (over a sidecar's or a CLI's), and those fields."""
    widths = family(cfg.model_type).widths(params)
    return dataclasses.replace(cfg, **widths), widths


def model_flags(parser, model_help=None, **fallbacks):
    """Add a CLI's ``--model_type`` and, for each of ``fallbacks``
    (``base_filters``, ``num_blocks``: the CLI's own default), that flag.
    Returns the function that fills a parsed namespace's unset widths:
    the family's ``cli_widths``, else the fallback."""
    parser.add_argument("--model_type", type=str, choices=list(FAMILIES),
                        default="unet", help=model_help)
    for name, fallback in fallbacks.items():
        told = [(f.name, f.flag_help[name], f.cli_widths.get(name, fallback))
                for f in FAMILIES.values() if name in f.flag_help]
        text = (", ".join([f"default {fallback}"] + [
            f"{n} {w} ({h})" for n, h, w in told]) if name == "base_filters"
            else "; ".join(f"{n}: {h} (default {w})" for n, h, w in told))
        parser.add_argument(f"--{name}", type=int, default=None, help=text)

    def fill(args):
        for name, fallback in fallbacks.items():
            if getattr(args, name) is None:
                setattr(args, name, FAMILIES[args.model_type].cli_widths
                        .get(name, fallback))
        return args
    return fill
