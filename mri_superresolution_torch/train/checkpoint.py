"""Checkpoint loading for serving: the JAX package's ``.ckpt`` and bare
``.msgpack`` params, and reference ``.pth`` files.

A ``.ckpt`` is a flax msgpack blob beside a JSON sidecar of hyperparams
(``<base>.json``). It is decoded here with ``msgpack`` alone: flax stores an
ndarray as ext type 1 holding msgpack ``(shape, dtype name, C-order
bytes)``, a numpy scalar as ext type 3 in the same encoding, and splits
arrays over 1 GiB into ``__msgpack_chunked_array__`` dicts. ``msgpack`` is
imported only when such a file is read. Discovery precedence mirrors the
reference: ``best_model_{type}`` -> ``final_model_{type}`` -> any file
naming the type (scripts/infer.py:74-95). Saving and resuming come with the
training slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from mri_superresolution_torch.models import KNOWN_MODEL_TYPES
from mri_superresolution_torch.utils.weights import state_dict_from_jax

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


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
    longer = [m for m in KNOWN_MODEL_TYPES
              if m != model_type and model_type in m]
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


def load_params_any(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Load unet params as this port's state_dict, with the checkpoint's
    meta: a ``.ckpt`` (params + sidecar), a bare ``.msgpack`` param tree,
    or a reference ``.pth`` (full checkpoint dict or bare state_dict)."""
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
        return {k: v.float() for k, v in sd.items()}, {"source": "torch"}
    base = path[:-5] if path.endswith(".ckpt") else path
    blob_path = path if path.endswith(".msgpack") else base + ".ckpt"
    with open(blob_path, "rb") as f:
        state = msgpack_restore(f.read())
    if path.endswith(".msgpack"):
        return state_dict_from_jax(state), {}
    return state_dict_from_jax(state["params"]), read_meta(path)
