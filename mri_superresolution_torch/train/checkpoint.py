"""Checkpoints in the JAX package's format: the ``.ckpt`` it writes and
reads, bare ``.msgpack`` params, and reference ``.pth`` files.

A ``.ckpt`` is a flax msgpack blob beside a JSON sidecar of hyperparams
(``<base>.json``). It is encoded and decoded here with ``msgpack`` alone:
flax stores an ndarray as ext type 1 holding msgpack ``(shape, dtype name,
C-order bytes)``, a numpy scalar as ext type 3 in the same encoding, and
splits arrays over 1 GiB into ``__msgpack_chunked_array__`` dicts (read
here; the unet's arrays are far smaller, so none is written). ``msgpack``
is imported only when such a file is read or written. The blob holds
``params`` as the JAX package's flax tree of the model's family
(``utils/weights``; the family is the meta's ``config.model.model_type``,
else the caller's),
``opt_state`` as optax's ``(add_decayed_weights, scale_by_adam)`` state
``{"0": {}, "1": {"count", "mu", "nu"}}`` with the moments mapped like the
params, and extras such as ``raw_params`` (the live weights under EMA,
mapped like the params) and ``qat_amax`` (QAT's running ranges, a flat
``{site: (Cin,) float32}`` tree as the JAX trainer writes it), so
checkpoints move both ways between the packages. Discovery precedence
mirrors the reference: ``best_model_{type}`` -> ``final_model_{type}`` ->
any file naming the type (scripts/infer.py:74-95).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mri_superresolution_torch.models.families import FAMILIES
from mri_superresolution_torch.utils.weights import (
    jax_params_from_state_dict, state_dict_from_jax)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
# extras stored as flat {name: float32 array} trees, not as model params
FLAT_EXTRAS = ("qat_amax",)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # widen the bf16 bits to fp32 (the high half of an fp32 word)
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(blob: bytes) -> Any:
    """Decode a flax ``msgpack_serialize`` blob into nested dicts of numpy
    arrays."""
    import msgpack
    return _unchunk(msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False))


def _ext_pack(x):
    import msgpack
    if isinstance(x, (np.ndarray, np.generic)):
        code = _EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR
        a = np.asarray(x)
        return msgpack.ExtType(code, msgpack.packb(
            (list(a.shape), a.dtype.name, a.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialize {type(x)}")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts of numpy arrays as flax's ``msgpack_serialize``
    does."""
    import msgpack
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def _atomic_write(path: str, data, mode: str) -> None:
    # a crash mid-save must never corrupt the previous checkpoint
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        if isinstance(data, (bytes, str)):
            f.write(data)
        else:
            json.dump(data, f, indent=2, sort_keys=True, default=str)
    os.replace(tmp, path)


def model_type_of(meta: Optional[Dict], default: str = "unet") -> str:
    """The family a checkpoint's meta names (``config.model.model_type``),
    else ``default``."""
    model = ((meta or {}).get("config") or {}).get("model") or {}
    return model.get("model_type", default)


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict[str, Any]] = None,
                    meta: Optional[Dict] = None,
                    extras: Optional[Dict[str, Dict[str, torch.Tensor]]]
                    = None, model_type: Optional[str] = None) -> None:
    """Write ``{path}.ckpt`` (msgpack) and ``{path}.json`` (meta sidecar),
    as the JAX package's ``save_checkpoint`` does.

    params: the port's state_dict of ``model_type`` (default: the family
    the meta names, else the unet); opt_state: ``{"count": int, "mu": sd,
    "nu": sd}`` (Adam's step and moments keyed like the params, see
    ``train.trainer.adam_state``); extras: further trees stored
    beside them: state_dicts (the trainer stores the live weights as
    ``raw_params`` under EMA), and the flat trees of ``FLAT_EXTRAS``
    (``qat_amax``, ``{site: (Cin,)}``), stored as float32 arrays."""
    family = model_type or model_type_of(meta)

    def tree(sd):
        return jax_params_from_state_dict(sd, family)

    state: Dict[str, Any] = {"params": tree(params)}
    if opt_state is not None:
        state["opt_state"] = {"0": {}, "1": {
            "count": np.asarray(opt_state["count"], np.int32),
            "mu": tree(opt_state["mu"]), "nu": tree(opt_state["nu"])}}
    for key, sd in (extras or {}).items():
        if key in state:
            raise ValueError(f"extras key {key!r} collides with {list(state)}")
        state[key] = ({k: np.asarray(torch.as_tensor(v).detach().cpu(),
                                     np.float32) for k, v in sd.items()}
                      if key in FLAT_EXTRAS else tree(sd))
    base = path[:-5] if path.endswith(".ckpt") else path
    _atomic_write(base + ".ckpt", msgpack_serialize(state), "wb")
    _atomic_write(base + ".json", meta or {}, "w")


def load_checkpoint(path: str, return_extras: bool = False,
                    model_type: str = "unet"):
    """Read a ``.ckpt`` of either package -> (params state_dict, opt_state
    ``{"count", "mu", "nu"}`` or None, meta dict), and with
    ``return_extras`` a fourth element: the other stored trees (e.g.
    ``raw_params``) as state_dicts, and those of ``FLAT_EXTRAS`` as flat
    ``{name: float32 tensor}`` dicts. The trees are mapped as the family
    the meta names, else as ``model_type``; a tree of another family
    raises ValueError."""
    base = path[:-5] if path.endswith(".ckpt") else path
    with open(base + ".ckpt", "rb") as f:
        state = msgpack_restore(f.read())
    meta = read_meta(path)
    family = model_type_of(meta, model_type)

    def sd(tree):
        return state_dict_from_jax(tree, family)

    opt = None
    adam = (state.get("opt_state") or {}).get("1")
    if adam:
        opt = {"count": int(adam["count"]), "mu": sd(adam["mu"]),
               "nu": sd(adam["nu"])}
    out = (sd(state["params"]), opt, meta)
    if return_extras:
        extras = {k: ({n: torch.from_numpy(np.array(a, np.float32))
                       for n, a in v.items()} if k in FLAT_EXTRAS else sd(v))
                  for k, v in state.items()
                  if k not in ("params", "opt_state")}
        return out + (extras,)
    return out


def read_meta(path: str) -> Dict:
    """The JSON sidecar ``<base>.json`` of a checkpoint, or {}."""
    base = path[:-5] if path.endswith(".ckpt") else path
    if os.path.exists(base + ".json"):
        with open(base + ".json") as f:
            return json.load(f)
    return {}


def checkpoint_paths(checkpoint_dir: str, model_type: str) -> Dict[str, str]:
    return {
        "best": os.path.join(checkpoint_dir, f"best_model_{model_type}"),
        "final": os.path.join(checkpoint_dir, f"final_model_{model_type}"),
        # mid-epoch step checkpoint (TrainConfig.save_every_steps): carries
        # a "batch_cursor" in its meta; resume prefers whichever of
        # final/step has the greater optimizer step count
        "step": os.path.join(checkpoint_dir, f"step_model_{model_type}"),
    }


def find_best_checkpoint(checkpoint_dir: str, model_type: str) -> str:
    """best -> final -> any-match precedence (scripts/infer.py:74-95), over
    ``.ckpt`` and reference ``.pth`` files."""
    names = checkpoint_paths(checkpoint_dir, model_type)
    for key in ("best", "final"):
        for ext in (".ckpt", ".pth"):
            if os.path.exists(names[key] + ext):
                return names[key] + ext
    # substring match like the reference, but never across model families:
    # a query for 'unet' must not pick up 'unet_tpu' checkpoints
    longer = [m for m in FAMILIES if m != model_type and model_type in m]
    for file in sorted(os.listdir(checkpoint_dir)):
        if not (file.endswith(".ckpt") or file.endswith(".pth")):
            continue
        if model_type in file and not any(m in file for m in longer):
            return os.path.join(checkpoint_dir, file)
    raise FileNotFoundError(
        f"No checkpoint found for {model_type} model in {checkpoint_dir}")


def resolve_checkpoint(checkpoint_dir: str, model_type: str,
                       checkpoint_path: str = None) -> str:
    """An explicit existing ``checkpoint_path`` wins; otherwise
    best -> final -> any discovery in ``checkpoint_dir``."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        return checkpoint_path
    return find_best_checkpoint(checkpoint_dir, model_type)


def calib_sidecar_path(path: str) -> str:
    """The QAT calibration sidecar written next to a checkpoint
    (``<base>.calib.json``), which ``load_engine`` serves int8 with."""
    return (path[:-len(".ckpt")] if path.endswith(".ckpt") else path
            ) + ".calib.json"


def load_params_any(path: str, model_type: str = "unet"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Load params as this port's state_dict, with the checkpoint's meta:
    a ``.ckpt`` (params + sidecar; the family its meta names, else
    ``model_type``), a bare ``.msgpack`` param tree (of ``model_type``), or
    a ``.pth`` state_dict (a reference unet checkpoint, full dict or bare
    state_dict, a published SwinIR file's ``params_ema`` or ``params``
    without its buffers, or a port state_dict). A param tree that does not fit the
    family raises ValueError."""
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt
        for key in ("model_state_dict", "params_ema", "params"):
            if key in ckpt:
                sd = ckpt[key]
                break
        # a published file may keep buffers that the port derives
        derived = tuple(b for f in FAMILIES.values()
                        for b in f.published_buffers)
        return ({k: v.float() for k, v in sd.items()
                 if not k.endswith(derived)}, {"source": "torch"})
    base = path[:-5] if path.endswith(".ckpt") else path
    blob_path = path if path.endswith(".msgpack") else base + ".ckpt"
    with open(blob_path, "rb") as f:
        state = msgpack_restore(f.read())
    if path.endswith(".msgpack"):
        return state_dict_from_jax(state, model_type), {}
    meta = read_meta(path)
    return state_dict_from_jax(state["params"],
                               model_type_of(meta, model_type)), meta
