"""The port's NIfTI codec against the JAX package's: a volume written by
either package reads back the same in the other, and the bytes they write
are the same."""

import numpy as np
import pytest

from mri_superresolution_tpu import nifti as jnifti
from mri_superresolution_torch import nifti


def _vol(kind, rng):
    if kind == "int16_slope":
        return ((rng.random((12, 10, 5)) * 3000).astype(np.int16),
                dict(zooms=(0.9, 1.1, 3.0), scl_slope=0.5, scl_inter=2.0))
    if kind == "float32":
        return (rng.random((8, 6, 4)).astype(np.float32),
                dict(zooms=(1.0, 1.0, 2.0)))
    if kind == "uint16":
        return ((rng.random((6, 7, 3)) * 60000).astype(np.uint16),
                dict(zooms=(0.5, 0.5, 1.5), scl_slope=2.0))
    return (rng.random((6, 5, 4, 3)).astype(np.float32),     # 4D
            dict(zooms=(1.0, 2.0, 3.0, 0.7)))


@pytest.mark.parametrize("kind", ["int16_slope", "float32", "uint16", "4d"])
@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_move_both_ways(tmp_path, kind, ext, writer):
    data, kw = _vol(kind, np.random.default_rng(0))
    path = str(tmp_path / ("v" + ext))
    (nifti if writer == "port" else jnifti).save(path, data, **kw)
    for raw in (False, True):
        got, ghdr = nifti.load(path, raw=raw)
        want, whdr = jnifti.load(path, raw=raw)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert ghdr.zooms == whdr.zooms and ghdr.shape == whdr.shape
        assert (ghdr.scl_slope, ghdr.scl_inter) == (whdr.scl_slope,
                                                    whdr.scl_inter)
        np.testing.assert_array_equal(ghdr.affine, whdr.affine)
    raw, _ = nifti.load(path, raw=True)
    np.testing.assert_array_equal(raw, data)     # the stored voxels


@pytest.mark.parametrize("compress", [False, True])
def test_bytes_and_header_are_the_jax_packages(compress):
    data, kw = _vol("int16_slope", np.random.default_rng(1))
    got = nifti.save_bytes(data, compress=compress, **kw)
    want = jnifti.save_bytes(data, compress=compress, **kw)
    if compress:   # gzip stamps a time: compare what it holds
        import gzip
        got, want = gzip.decompress(got), gzip.decompress(want)
    assert got == want
    for buf in (got, want):
        a, hdr = nifti.load_bytes(buf)
        b, jhdr = jnifti.load_bytes(buf)
        np.testing.assert_array_equal(a, b)
        assert hdr.zooms == jhdr.zooms
    # an F-ordered volume (the zero-copy serving output) writes the same
    f = np.asfortranarray(data)
    assert nifti.save_bytes(f, **kw)[352:] == jnifti.save_bytes(
        data, **kw)[352:]
    assert nifti.encode_header(data.shape, data.dtype, **kw) == \
        jnifti.encode_header(data.shape, data.dtype, **kw)
    hdr, order = nifti.read_header(got)
    jhdr, jorder = jnifti.read_header(got)
    assert order == jorder and hdr.dim == jhdr.dim
    assert hdr.datatype == jhdr.datatype == 4


def test_rejects_what_jax_rejects(tmp_path):
    with pytest.raises(ValueError, match="too small"):
        nifti.load_bytes(b"short")
    bad = bytearray(nifti.save_bytes(np.zeros((2, 2, 2), np.float32)))
    bad[344:348] = b"xxxx"
    with pytest.raises(ValueError, match="magic"):
        nifti.load_bytes(bytes(bad))
    neg = nifti.save_bytes(np.ones((2, 2, 2), np.int16), scl_slope=-1.0)
    with pytest.raises(ValueError, match="non-negative"):
        nifti.load_bytes(neg, raw=True)
