"""Kernel B5's plain versions (the roll/stencil probe, ``kernels/
roll_probe.py``) against the TPU probe's own numpy expectation
(tools/bench_roll_probe.py:111-131), on the CPU, where the wrappers run
their plain versions. The CUDA kernels are held to these on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_superresolution_torch.kernels import (launch_counts,
                                               reset_launch_counts, roll32,
                                               roll_copy, taps3)
from mri_superresolution_torch.tools import roll_probe

torch.set_num_threads(2)

R_BLK = 64


def _x(rows, lanes):
    """The probe's input: seeded standard normal, as bf16."""
    return jnp.asarray(np.random.default_rng(0).standard_normal(
        (rows, lanes)), jnp.bfloat16)


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _taps3_want(x, rows, lanes):
    """bench_roll_probe.py:115-131, verbatim in its arithmetic."""
    xr = np.asarray(x, np.float32)
    lane = np.arange(lanes)[None, :]
    want = np.empty_like(xr)
    for blk in range(rows // R_BLK):
        s = blk * R_BLK
        xb = xr[s:s + R_BLK]
        rolled = np.where(lane < 32, 0.0, np.roll(xb[1:R_BLK - 1], 32, 1))
        acc = np.asarray(
            jnp.asarray(np.asarray(
                jnp.asarray(xb[0:R_BLK - 2], jnp.bfloat16)
                + jnp.asarray(rolled, jnp.bfloat16), np.float32),
                jnp.bfloat16)
            + jnp.asarray(xb[2:R_BLK], jnp.bfloat16), np.float32)
        want[s:s + R_BLK - 2] = acc
        want[s + R_BLK - 2:s + R_BLK] = xb[R_BLK - 2:]
    return want


@pytest.mark.parametrize("rows,lanes", [(128, 256), (64, 40)])
def test_plain_versions_match_the_probe(rows, lanes):
    x = _x(rows, lanes)
    xt = _torch(x)
    reset_launch_counts()
    np.testing.assert_array_equal(roll_copy(xt).float().numpy(),
                                  np.asarray(x, np.float32))
    np.testing.assert_array_equal(
        roll32(xt).float().numpy(), np.roll(np.asarray(x, np.float32), 32,
                                            axis=1))
    np.testing.assert_array_equal(taps3(xt).float().numpy(),
                                  _taps3_want(x, rows, lanes))
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(v == 0 for v in launch_counts().values())


def test_wrappers_check_their_inputs():
    x = torch.zeros(64, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        roll32(x.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        roll_copy(torch.zeros(64, 36, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="rows"):
        taps3(torch.zeros(32, 40, dtype=torch.bfloat16))
    assert roll32(torch.zeros(32, 40, dtype=torch.bfloat16)).shape == (32, 40)
    with pytest.raises(ValueError, match="contiguous"):
        roll_copy(torch.zeros(40, 64, dtype=torch.bfloat16).t())


def test_probe_entry_point_on_cpu(capsys):
    res = roll_probe.run(128, 256, device="cpu")
    assert set(res) == {"copy", "roll32", "taps3"}
    assert all(r == {"exact": True} for r in res.values())
    assert roll_probe.main(["--cpu", "--rows", "64", "--lanes", "64"]) == 0
    assert '"exact": true' in capsys.readouterr().out
