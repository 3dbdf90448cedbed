"""``epilogue_roofline``'s byte count and its reading of a made-up trace."""

import json

import pytest

from benchmark import core, counts, devtrace

MAN = json.loads((core.HERE.parent / "BENCHMARK.json").read_text())
NAME = ("void (anonymous namespace)::bias_epilogue_kernel<__nv_bfloat16, 8, "
        "true, false>(__nv_bfloat16 const*, float const*, __nv_bfloat16 "
        "const*, __nv_bfloat16*, long long, int, float)")


def _reading(device, cfg):
    tr = devtrace.DeviceTrace(0, 10**9)
    tr.device = device
    return {"trace": tr, "config": cfg, "b1_site_hw": (256, 256),
            "slices_per_forward": 48.0}


def test_bytes_a_slice_at_edsr_baseline():
    read = core.reader("epilogue_roofline")
    cfg, _ = core.config(MAN, "edsr-baseline-x2")
    mod = read.__globals__
    assert mod["bytes_per_slice"](256, 256, cfg["base_filters"],
                                  cfg["num_blocks"]) == 713_031_680


def test_reads_the_kernels_time_against_the_bound():
    """Two forwards (68 launches of 100 us), among other kernels: the bound
    of two 48-slice forwards' bytes over 6.8 ms."""
    cfg, _ = core.config(MAN, "edsr-baseline-x2")
    dev = [(i * 200_000, i * 200_000 + 100_000, NAME) for i in range(68)]
    dev += [(5, 6, "sm90_xmma_fprop_implicit_gemm_bf16"),
            (7, 9, "at::native::vectorized_elementwise_kernel_8_")]
    got = core.reader("epilogue_roofline")(_reading(dev, cfg))
    want = 100.0 * 2 * 48 * 713_031_680 / counts.PEAK_HBM_BYTES_PER_S / 6.8e-3
    assert got == pytest.approx(want)


def test_a_program_without_the_kernel_reads_nothing():
    cfg, _ = core.config(MAN, "edsr-baseline-x2")
    dev = [(0, 10, "sm90_xmma_fprop_implicit_gemm_bf16")]
    assert core.reader("epilogue_roofline")(_reading(dev, cfg)) is None
