"""The FLOP and byte counts against the figures the benchmark quotes."""

import pytest

from benchmark import counts


def test_unet_flops_per_slice():
    assert counts.unet_flops_per_slice(256, 256) / 1e9 == pytest.approx(
        24.41, abs=0.005)
    # a training step: forward and a backward of twice its FLOPs at 128^2
    assert 3 * counts.unet_flops_per_slice(128, 128) / 1e9 == pytest.approx(
        18.30, abs=0.005)


def test_edsr_baseline_flops_per_slice():
    assert counts.edsr_flops_per_slice(256, 256) / 1e9 == pytest.approx(
        159.83, abs=0.005)


def test_b1_sites():
    sites = counts.unet_b1_sites(256, 256)
    assert len(sites) == 20
    assert not any(res for _, _, res in sites)


@pytest.mark.parametrize("which, batch, side, bound_us", [
    ("forward", 16, 256, 601.0),
    ("backward", 8, 128, 112.7),
])
def test_b1_byte_bounds(which, batch, side, bound_us):
    fn = {"forward": counts.b1_forward_bytes_per_slice,
          "backward": counts.b1_backward_bytes_per_slice}[which]
    us = batch * fn(side, side) / counts.PEAK_HBM_BYTES_PER_S * 1e6
    assert us == pytest.approx(bound_us, abs=0.05)
