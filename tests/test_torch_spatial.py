"""The port's row-sharded forwards (``parallel/spatial.py``) against the JAX
package's (``parallel/spatial.py`` there, on its 8-device CPU mesh) and
against the port's own dense forwards, on the CPU, where the wrappers of
kernels B3 and B4 run their plain versions.

The same seeded numpy inputs and JAX-initialised parameters (carried over
by ``utils/weights.py``) go through both packages. Tolerances are the JAX
tests' (``tests/test_spatial.py``): fp32 within rtol 1e-4, atol 3e-5;
int8 bit-exact for edsr and simple (no GroupNorm), and for the unets the
quality contract ``_assert_int8_quality``, since a GroupNorm sum taken in
another order can flip an int8 code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_tpu.config import ModelConfig as JaxModelConfig
from mri_superresolution_tpu.models import build_model as jax_build_model
from mri_superresolution_tpu.models import init_params
from mri_superresolution_tpu.models import quant_forward as jqf
from mri_superresolution_tpu.parallel import (
    build_spatial_calib_forward_raw as jax_calib_raw,
    build_spatial_forward as jax_spatial_forward,
    build_spatial_int8_forward_raw as jax_int8_raw,
    make_spatial_mesh as jax_mesh)
from mri_superresolution_torch.config import ModelConfig
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.models import quant_forward as qf
from mri_superresolution_torch.parallel import (
    build_spatial_calib_forward_raw, build_spatial_forward,
    build_spatial_int8_forward_raw, make_spatial_mesh)
from mri_superresolution_torch.parallel import spatial
from mri_superresolution_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)
CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 3e-5


def _rand(n, h, w, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 1), np.float32)


def _jax_params(model_type, seed):
    model = jax_build_model(JaxModelConfig(model_type=model_type,
                                           base_filters=16),
                            dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(model, jax.random.key(seed), (32, 32)))
    return model, params


@pytest.fixture(scope="module")
def families():
    """Per family: the JAX model and params (the JAX tests' seeds) and the
    port's state_dict of the same weights."""
    out = {}
    for mt, seed in (("unet", 0), ("unet_tpu", 1), ("edsr", 2),
                     ("simple", 2)):
        model, params = _jax_params(mt, seed)
        out[mt] = (model, params, state_dict_from_jax(params, mt))
    return out


def _dense(sd, model_type, x, dtype=torch.float32):
    m = build_model(ModelConfig(model_type=model_type, base_filters=16),
                    dtype=dtype)
    m.load_state_dict(sd)
    with torch.no_grad():
        return m.eval()(torch.from_numpy(x)).numpy()


def _mesh(n_data, n_space):
    return make_spatial_mesh(n_data, n_space, [CPU] * (n_data * n_space))


def _port(sd, model_type, x, mesh_shape, dtype=torch.float32):
    fwd = build_spatial_forward(_mesh(*mesh_shape), x.shape[1:3], dtype,
                                model_type)
    return fwd(sd, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (4, 2)])
@pytest.mark.parametrize("model_type", ["unet", "unet_tpu"])
def test_matches_jax_and_dense(families, model_type, mesh_shape):
    """The unets over three grids: the port's spatial forward against
    JAX's spatial forward and against the port's dense forward."""
    _, params, sd = families[model_type]
    n_data, n_space = mesh_shape
    h = 8 * n_space * 2          # two rows a shard at the deepest stage
    x = _rand(n_data * 2, h, 64)
    got = _port(sd, model_type, x, mesh_shape)
    want = np.asarray(jax_spatial_forward(
        jax_mesh(n_data, n_space), (h, 64), dtype=jnp.float32,
        model_type=model_type)(params, x))
    assert got.shape == want.shape == (x.shape[0], 2 * h, 128, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _dense(sd, model_type, x), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("model_type", ["edsr", "simple"])
def test_trunk_families_match_jax_and_dense(families, model_type):
    """edsr and simple over (2, 4): trunks whose only collectives are kxk
    halos (simple's 9x9 extract takes 4 rows from each neighbour)."""
    _, params, sd = families[model_type]
    x = _rand(4, 32, 64, seed=3)
    got = _port(sd, model_type, x, (2, 4))
    want = np.asarray(jax_spatial_forward(
        jax_mesh(2, 4), (32, 64), dtype=jnp.float32,
        model_type=model_type)(params, x))
    assert got.shape == (4, 64, 128, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _dense(sd, model_type, x), rtol=RTOL,
                               atol=ATOL)


def test_bf16_as_accurate_as_dense_bf16(families):
    """bf16 sums in another order, so the sharded output is not the dense
    bf16 one bit for bit: it must be as close to the fp32 truth (the JAX
    test's bounds)."""
    _, _, sd = families["unet"]
    x = _rand(4, 64, 64, seed=1)
    truth = _dense(sd, "unet", x)
    dense16 = _dense(sd, "unet", x, torch.bfloat16)
    sharded16 = _port(sd, "unet", x, (2, 4), torch.bfloat16)
    e_sp, e_d = np.abs(sharded16 - truth), np.abs(dense16 - truth)
    assert e_sp.mean() <= 2.0 * e_d.mean() + 1e-4
    assert np.quantile(e_sp, 0.999) <= 2.0 * np.quantile(e_d, 0.999) + 1e-3


def test_shape_validation():
    mesh = _mesh(2, 4)
    with pytest.raises(ValueError, match="divisible by 8\\*n_space"):
        build_spatial_forward(mesh, (40, 64))
    with pytest.raises(ValueError, match="divisible by 8"):
        build_spatial_forward(mesh, (64, 60))
    with pytest.raises(ValueError, match="supports model types"):
        build_spatial_forward(mesh, (64, 64), model_type="hourglass")
    assert spatial.supported_types() == ["edsr", "simple", "unet",
                                         "unet_tpu"]
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_spatial_mesh(2, 4, [CPU] * 6)


def test_all_sum_gives_every_shard_the_same_bits():
    """The shards' partials added once, in shard order: every shard gets
    the one result, so a GroupNorm's mean and variance are the same bits
    on every shard (no seam at a shard border), and the normalized rows
    are the dense GroupNorm's; all_max likewise."""
    from mri_superresolution_torch.ops.functional import group_norm_ref

    class Recording(spatial.SpaceGroup):
        def all_sum(self, ts):
            out = super().all_sum(ts)
            self.seen.append(out)
            return out

    rng = np.random.default_rng(0)
    group = Recording([CPU] * 4)
    group.seen = []
    parts = [torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)
                              * 1e3) for _ in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(s, want) for s in group.all_sum(parts))
    maxes = group.all_max(parts)
    assert all(torch.equal(m, torch.stack(parts).amax(0)) for m in maxes)

    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 8)).astype(
        np.float32) * 3 + 1).contiguous(memory_format=torch.channels_last)
    scale = torch.from_numpy(rng.random(16).astype(np.float32) + 0.5)
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    group.seen = []
    ys = spatial._group_norm(group, [x[:, :, 4 * i:4 * (i + 1)]
                                     for i in range(4)],
                             [scale] * 4, [bias] * 4)
    (stats,) = group.seen
    n = 16 * 8 * 2
    means = [st[0] / n for st in stats]
    varis = [st[1] / n - m * m for st, m in zip(stats, means)]
    for m, v in zip(means[1:], varis[1:]):
        assert torch.equal(m, means[0]) and torch.equal(v, varis[0])
    np.testing.assert_allclose(torch.cat(ys, dim=2).numpy(),
                               group_norm_ref(x, scale, bias).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_halo_edges_are_zero_and_rows_are_the_neighbours():
    """The halo of shard i: the previous shard's last rows above and the
    next shard's first rows below; zero rows beyond the image, the dense
    conv's padding. Nothing is written into a shard's block."""
    x = torch.arange(2 * 3 * 12 * 4, dtype=torch.float32).reshape(
        2, 3, 12, 4).contiguous(memory_format=torch.channels_last)
    group = spatial.SpaceGroup([CPU] * 3)
    blocks = [x[:, :, 4 * i:4 * (i + 1)] for i in range(3)]
    before = [b.clone() for b in blocks]
    ext = group.halo(blocks, 2, 1)
    padded = torch.nn.functional.pad(x, (0, 0, 2, 1))
    for i, e in enumerate(ext):
        assert e.shape == (2, 3, 7, 4)
        assert torch.equal(e, padded[:, :, 4 * i:4 * i + 7])
        assert e.is_contiguous(memory_format=torch.channels_last)
    assert all(torch.equal(a, b) for a, b in zip(blocks, before))


def _assert_int8_quality(sp, dense, truth):
    """The JAX tests' contract between two int8 paths of a GroupNorm
    family: as close to the fp32 truth, in mean and at the 0.999
    quantile."""
    e_sp = np.abs(np.asarray(sp, np.float32) - np.asarray(truth, np.float32))
    e_d = np.abs(np.asarray(dense, np.float32)
                 - np.asarray(truth, np.float32))
    assert e_sp.mean() <= 1.1 * e_d.mean() + 1e-5, \
        f"mean {e_sp.mean()} vs dense {e_d.mean()}"
    assert np.quantile(e_sp, 0.999) <= 1.2 * np.quantile(e_d, 0.999) + 1e-3


@pytest.mark.parametrize("model_type", ["unet", "unet_tpu", "edsr", "simple"])
def test_int8_matches_jax_and_dense_int8(families, model_type):
    """The frozen-scale int8 forward over (2, 4) in fp32 from JAX's
    calibration scales: against the port's dense int8 forward and JAX's
    spatial int8 forward: bit-exact against the dense int8 for edsr and
    simple, the quality contract for the unets and against JAX; the
    calibration forward's amax equals the
    dense ``calib_amax`` within rtol 1e-5, atol 1e-6 at every site."""
    model, params, sd = families[model_type]
    x = _rand(2, 32, 32, seed=5)
    truth = _dense(sd, model_type, x)
    scales = jqf.calibrate(params, [x], model_type, dtype=jnp.float32)
    mesh = _mesh(2, 4)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        dense = qf.build_int8_forward(sd, scales, model_type,
                                      torch.float32)(sd, xt).numpy()
        got = build_spatial_int8_forward_raw(
            mesh, (32, 32), sd, scales, model_type, torch.float32)(
                sd, xt).numpy()
    want = np.asarray(jax.jit(jax_int8_raw(
        jax_mesh(2, 4), (32, 32), params, scales, model_type,
        dtype=jnp.float32))(params, x))
    if model_type in ("edsr", "simple"):
        np.testing.assert_array_equal(got, dense)
    else:
        _assert_int8_quality(got, dense, truth)
    # the packages round their fp32 tails apart (a few codes move even
    # between the dense int8 forwards): JAX's spatial int8 is held to the
    # quality contract
    _assert_int8_quality(got, want, truth)

    sites = sorted(qf.amax_template(sd, model_type))
    assert sites == sorted(jqf.amax_template(params, (1, 32, 32, 1),
                                             model_type, dtype=jnp.float32))
    with torch.no_grad():
        _, amax = build_spatial_calib_forward_raw(
            mesh, (32, 32), sites, model_type, torch.float32)(sd, xt)
        dense_amax = qf.calib_amax(sd, xt, model_type, torch.float32)
    _, jax_amax = jax.jit(jax_calib_raw(jax_mesh(2, 4), (32, 32), sites,
                                        model_type, dtype=jnp.float32))(
        params, x)
    assert sorted(amax) == sorted(dense_amax) == sites
    for k in sites:
        np.testing.assert_allclose(amax[k].numpy(), dense_amax[k].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(amax[k].numpy(), np.asarray(jax_amax[k]),
                                   rtol=1e-5, atol=1e-6)


def test_calib_forward_checks_its_sites(families):
    _, _, sd = families["simple"]
    fn = build_spatial_calib_forward_raw(_mesh(1, 2), (32, 32),
                                         ["extract", "map", "ghost"],
                                         "simple", torch.float32)
    with pytest.raises(AssertionError, match="ghost"):
        fn(sd, torch.zeros((1, 32, 32, 1)))


def test_int8_scales_must_cover_every_site(families):
    _, _, sd = families["unet"]
    scales = {"inc.conv1": np.ones(1, np.float32)}
    with pytest.raises(ValueError, match="missing for sites"):
        build_spatial_int8_forward_raw(_mesh(1, 2), (32, 32), sd, scales,
                                       "unet", torch.float32)


def test_params_per_device(families):
    """One state_dict a device of the grid gives the output of one shared
    state_dict; a list of the wrong length is refused."""
    _, _, sd = families["unet"]
    x = torch.from_numpy(_rand(2, 32, 32, seed=9))
    fwd = build_spatial_forward(_mesh(2, 2), (32, 32), torch.float32,
                                "unet")
    copies = [{k: v.clone() for k, v in sd.items()} for _ in range(4)]
    assert torch.equal(fwd(copies, x), fwd(sd, x))
    with pytest.raises(ValueError, match="3 state_dicts"):
        fwd(copies[:3], x)
