"""The port's per-slice normalize (``ops/normalize.py``) against the JAX
package's on the CPU: uint8, int16, uint16 and float32 slices, a constant
slice among them, within one fp32 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.ops import normalize as jnorm
from mri_superresolution_torch.ops import normalize as tnorm

torch.set_num_threads(2)


def _batch(dtype, rng, shape=(4, 20, 23)):
    if dtype == np.float32:
        x = (rng.random(shape) * 900 - 50).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(max(info.min, -3000), min(info.max, 60000) + 1,
                         shape).astype(dtype)
    x[1] = x[1, 0, 0]                    # a constant slice
    x[2, :3] = x[2].max()                # ties at the top percentile
    return x


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in fp32 ulps (representable values apart)."""
    def key(a):
        i = np.ascontiguousarray(a, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(got) - key(want)).max())


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint16,
                                   np.float32])
@pytest.mark.parametrize("name", ["percentile_window", "minmax_normalize",
                                  "robust_normalize", "serving"])
def test_normalize_matches_jax(dtype, name):
    x = _batch(dtype, np.random.default_rng(0))
    if name == "serving":
        got = tnorm.normalize_slices(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.vmap(lambda s: jnorm.minmax_normalize(
            jnorm.percentile_window(s)))(jnp.asarray(x)))
    else:
        got = getattr(tnorm, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.vmap(getattr(jnorm, name))(jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == x.shape
    assert _ulps(got, want) <= 1.0


@pytest.mark.parametrize("n", [1, 2, 7, 200, 201, 460, 4096])
@pytest.mark.parametrize("q", [0.5, 99.5, 0.0, 100.0, 37.3])
def test_percentile_is_jax_linear(n, q):
    """JAX's fp32 formula, not torch.quantile's lerp, at sizes where
    q * (n - 1) is exact, lands between two values or at the ends: the
    bits of JAX's batched percentile (the engine's normalize vmaps it),
    and within one ulp of a single slice's ``jnp.percentile``."""
    x = (np.random.default_rng(n).random((3, 1, n)) * 1e3).astype(
        np.float32)
    lo, hi = tnorm._percentiles(torch.from_numpy(x), q, 100.0 - q)
    for got, p in ((lo, q), (hi, 100.0 - q)):
        got = got[:, 0, 0].numpy()
        batched = np.asarray(jax.vmap(lambda s: jnp.percentile(s, p))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(got, batched)
        single = np.stack([np.asarray(jnp.percentile(x[i], p))
                           for i in range(3)])
        assert _ulps(got, single) <= 1
