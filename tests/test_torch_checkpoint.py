"""Checkpoints written by the JAX package load in the port without JAX."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.infer import InferenceEngine as JaxEngine
from mri_superresolution_tpu.models import UNetSuperRes as JaxUNet
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.train import checkpoint as jax_ckpt
from mri_superresolution_tpu.utils.torch_compat import save_torch_checkpoint
from mri_superresolution_torch.train import checkpoint as ckpt
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE_WITHOUT_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "mri_superresolution_tpu"):
    sys.modules[name] = None          # any import of these now fails
import numpy as np, torch
torch.set_num_threads(2)
from mri_superresolution_torch.config import InferConfig, ModelConfig
from mri_superresolution_torch.infer import load_engine
eng = load_engine(InferConfig(model=ModelConfig(base_filters=64),
                              checkpoint_dir=sys.argv[1], bf16=False),
                  device="cpu")
assert eng.model_cfg.base_filters == 16, eng.model_cfg
np.save(sys.argv[3], eng.upscale_batch(np.load(sys.argv[2])))
print("SERVED")
"""


@pytest.fixture(scope="module")
def jax_params():
    params = init_params(JaxUNet(base_filters=16), jax.random.key(0),
                         (16, 16))
    return jax.tree_util.tree_map(np.asarray, params)


def test_jax_ckpt_serves_without_jax(tmp_path, jax_params):
    d = str(tmp_path)
    jax_ckpt.save_checkpoint(os.path.join(d, "best_model_unet"), jax_params,
                             meta={"config": {"model": {
                                 "model_type": "unet", "base_filters": 16,
                                 "num_blocks": 8}}})
    x = np.random.default_rng(0).random((2, 16, 24)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _SERVE_WITHOUT_JAX, d, str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")], env=env, cwd=d, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0 and "SERVED" in r.stdout, r.stderr[-3000:]
    want = JaxEngine(JaxModelConfig(base_filters=16), jax_params, bf16=False,
                     num_devices=1).upscale_batch(x)
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), want, rtol=1e-4,
                               atol=1e-5)


def test_msgpack_decoder_matches_flax(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.float32(2.5), "d": np.array([1, 2], np.int64),
                  "e": np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16))},
            "n": 3}
    blob = serialization.msgpack_serialize(tree)
    got = ckpt.msgpack_restore(blob)
    want = serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["b"]["c"] == want["b"]["c"] == np.float32(2.5)
    np.testing.assert_array_equal(got["b"]["d"], want["b"]["d"])
    np.testing.assert_array_equal(got["b"]["e"], [1.5, -2.0])
    assert got["n"] == 3


def test_load_params_any_formats(tmp_path, jax_params):
    want = state_dict_from_jax(jax_params)
    base = str(tmp_path / "final_model_unet")
    jax_ckpt.save_checkpoint(base, jax_params, meta={"epoch": 4})
    with open(tmp_path / "bare.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(jax_params))
    save_torch_checkpoint(str(tmp_path / "ref.pth"), jax_params)
    for path, meta in ((base + ".ckpt", {"epoch": 4}),
                       (str(tmp_path / "bare.msgpack"), {}),
                       (str(tmp_path / "ref.pth"), {"source": "torch"})):
        sd, got_meta = ckpt.load_params_any(path)
        assert got_meta == meta, path
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), (path, k)


def test_find_best_checkpoint_precedence(tmp_path):
    d = str(tmp_path)
    for name in ("unet_tpu_model.ckpt", "old_unet.pth"):
        open(os.path.join(d, name), "w").close()
    # any-match never crosses families: unet_tpu files are not unet files
    assert ckpt.find_best_checkpoint(d, "unet").endswith("old_unet.pth")
    open(os.path.join(d, "final_model_unet.ckpt"), "w").close()
    assert ckpt.find_best_checkpoint(d, "unet").endswith(
        "final_model_unet.ckpt")
    open(os.path.join(d, "best_model_unet.pth"), "w").close()
    assert ckpt.find_best_checkpoint(d, "unet").endswith(
        "best_model_unet.pth")
    explicit = os.path.join(d, "old_unet.pth")
    assert ckpt.resolve_checkpoint(d, "unet", explicit) == explicit
    with pytest.raises(FileNotFoundError):
        ckpt.find_best_checkpoint(d, "edsr")
    with open(os.path.join(d, "final_model_unet.json"), "w") as f:
        json.dump({"config": {"model": {"base_filters": 8}}}, f)
    assert ckpt.read_meta(os.path.join(d, "final_model_unet.ckpt")) == {
        "config": {"model": {"base_filters": 8}}}
