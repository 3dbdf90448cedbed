"""Minimal NIfTI-1 reader/writer, implemented from the file-format spec.

The port's own copy of the JAX package's pure-numpy ``nifti.py`` (no torch,
no JAX): the same codec and the same bytes, so a volume written by either
package reads back the same in the other. It replaces the reference's
nibabel dependency (scripts/extract_paired_slices.py
``nib.load(...).get_fdata()``):

- reads ``.nii`` and ``.nii.gz``, 3D/4D volumes,
- handles both endiannesses (sniffed from sizeof_hdr),
- supports the common datatypes (u/int8/16/32, float32/64),
- applies scl_slope/scl_inter like nibabel's ``get_fdata`` (float64 output),
- writes valid single-file NIfTI-1 (magic ``n+1``) for synthetic test data.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348
# the header's description field, the JAX package's, so that both packages
# write byte-identical files
_DESCRIP = b"mri_superresolution_tpu"


@dataclass
class NiftiHeader:
    dim: Tuple[int, ...] = (3, 1, 1, 1, 1, 1, 1, 1)
    datatype: int = 16
    bitpix: int = 32
    pixdim: Tuple[float, ...] = (1.0,) * 8
    vox_offset: float = 352.0
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    descrip: bytes = _DESCRIP
    affine: np.ndarray = field(default_factory=lambda: np.eye(4))

    @property
    def shape(self) -> Tuple[int, ...]:
        ndim = self.dim[0]
        return tuple(int(d) for d in self.dim[1:1 + ndim])

    @property
    def zooms(self) -> Tuple[float, ...]:
        ndim = self.dim[0]
        return tuple(float(z) for z in self.pixdim[1:1 + ndim])


def _open(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_header(raw: bytes) -> Tuple[NiftiHeader, str]:
    """Parse a 348-byte NIfTI-1 header; returns (header, byteorder '<'/'>')."""
    if len(raw) < HDR_SIZE:
        raise ValueError("File too small to be NIfTI-1")
    (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
    order = "<"
    if sizeof_hdr != HDR_SIZE:
        (sizeof_hdr,) = struct.unpack(">i", raw[0:4])
        if sizeof_hdr != HDR_SIZE:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr)")
        order = ">"

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"Bad NIfTI magic: {magic!r}")

    dim = struct.unpack(order + "8h", raw[40:56])
    (datatype, bitpix) = struct.unpack(order + "2h", raw[70:74])
    pixdim = struct.unpack(order + "8f", raw[76:108])
    (vox_offset, scl_slope, scl_inter) = struct.unpack(order + "3f", raw[108:120])
    srow = np.array(struct.unpack(order + "12f", raw[280:328]),
                    dtype=np.float64).reshape(3, 4)
    affine = np.eye(4)
    (sform_code,) = struct.unpack(order + "h", raw[254:256])
    if sform_code > 0:
        affine[:3, :] = srow
    else:
        affine[0, 0] = pixdim[1]
        affine[1, 1] = pixdim[2]
        affine[2, 2] = pixdim[3]

    hdr = NiftiHeader(dim=dim, datatype=datatype, bitpix=bitpix,
                      pixdim=pixdim, vox_offset=vox_offset,
                      scl_slope=scl_slope, scl_inter=scl_inter,
                      affine=affine)
    return hdr, order


def load(path: str, raw: bool = False) -> Tuple[np.ndarray, NiftiHeader]:
    """Read a NIfTI volume → (float64 data with scaling applied, header).

    Matches nibabel ``get_fdata()`` semantics: output is float64,
    ``data * scl_slope + scl_inter`` applied when slope is finite and not
    the identity (slope 0 means "no scaling" per the spec).

    ``raw=True`` returns the STORED voxel values in their native dtype
    with NO scaling and NO float64 conversion — the fast path for
    serving pipelines whose first device op is a scale-invariant
    normalize (percentile-window + minmax is invariant under positive
    affine intensity maps), so int16-coded volumes upload at 2
    bytes/voxel instead of 8 (``cli/infer_volume.py --serve_raw``).
    """
    with _open(path) as f:
        return load_bytes(f.read(), raw=raw, _gunzip=False)


def load_bytes(buf: bytes, raw: bool = False,
               _gunzip: bool = True) -> Tuple[np.ndarray, NiftiHeader]:
    """:func:`load` for an in-memory ``.nii``/``.nii.gz`` byte string
    (gzip sniffed by magic) — the serving daemon's volume endpoint
    decodes uploads with this, no temp files."""
    if _gunzip and buf[:2] == b"\x1f\x8b":
        buf = gzip.decompress(buf)
    data, hdr = _stored(buf)
    if raw:
        slope = hdr.scl_slope
        if np.isfinite(slope) and slope < 0:
            raise ValueError(
                "raw=True requires a non-negative scl_slope (a negative "
                "slope flips intensity order, which scale-invariant "
                "normalizes do not absorb)")
        if data.dtype.byteorder == ">":
            data = data.astype(data.dtype.newbyteorder("<"))
        return data, hdr
    return apply_scaling(data, hdr), hdr


def _stored(buf: bytes) -> Tuple[np.ndarray, NiftiHeader]:
    """The voxels of an uncompressed NIfTI-1 byte string as stored (the
    file's dtype and byte order, F-order view of ``buf``), and its header."""
    hdr, order = read_header(buf)
    if hdr.datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {hdr.datatype}")
    dtype = np.dtype(_DTYPES[hdr.datatype]).newbyteorder(order)
    count = int(np.prod(hdr.shape)) if hdr.shape else 0
    data = np.frombuffer(buf, dtype=dtype, count=count,
                         offset=int(hdr.vox_offset))
    return data.reshape(hdr.shape, order="F"), hdr


def apply_scaling(stored: np.ndarray, hdr: NiftiHeader) -> np.ndarray:
    """Stored voxel values -> float64 physical values, as :func:`load`
    gives them: ``data * scl_slope + scl_inter`` when the slope is finite
    and not the identity (0 means no scaling). Elementwise, so scaling a
    selection of slices equals selecting them from the scaled volume."""
    data = np.asarray(stored).astype(np.float64)
    slope, inter = hdr.scl_slope, hdr.scl_inter
    if np.isfinite(slope) and slope != 0 and (slope, inter) != (1.0, 0.0):
        data = data * slope + inter
    return data


def load_stored(path: str) -> Tuple[np.ndarray, NiftiHeader]:
    """The stored voxel values (native dtype, no scaling, a slope of any
    sign) and the header: for callers that take a few slices and scale
    only those with :func:`apply_scaling` (``data/extraction.py``)."""
    with _open(path) as f:
        return _stored(f.read())


def save(path: str, data: np.ndarray,
         zooms: Optional[Tuple[float, ...]] = None,
         affine: Optional[np.ndarray] = None,
         scl_slope: float = 1.0, scl_inter: float = 0.0) -> None:
    """Write a 3D/4D array as single-file NIfTI-1 (little-endian).

    ``scl_slope``/``scl_inter`` are stored in the header so integer-coded
    volumes (e.g. int16 super-resolution output packed as round(y*32767))
    decode back to physical values via ``load``'s nibabel-parity scaling
    (data * slope + inter)."""
    data, hdr = _encode(data, zooms, affine, scl_slope, scl_inter)
    with _open(path, "wb") as f:
        f.write(hdr)
        f.write(b"\x00" * 4)  # extension flag
        if data.flags.f_contiguous:
            # F-contiguous memory already IS the file's voxel order: write
            # the buffer via its C-contiguous transpose view, no tobytes
            # copy (the zero-copy serving path lands here — its outputs
            # are .T views of C-order batches)
            f.write(memoryview(data.T))
        else:
            f.write(np.asfortranarray(data).tobytes(order="F"))


def save_bytes(data: np.ndarray,
               zooms: Optional[Tuple[float, ...]] = None,
               affine: Optional[np.ndarray] = None,
               scl_slope: float = 1.0, scl_inter: float = 0.0,
               compress: bool = False) -> bytes:
    """:func:`save` to an in-memory byte string (``.nii``, or ``.nii.gz``
    with ``compress``) — the serving daemon's volume endpoint encodes
    responses with this."""
    data, hdr = _encode(data, zooms, affine, scl_slope, scl_inter)
    body = (hdr + b"\x00" * 4
            + (bytes(memoryview(data.T)) if data.flags.f_contiguous
               else np.asfortranarray(data).tobytes(order="F")))
    return gzip.compress(body, compresslevel=1) if compress else body


def encode_header(shape, dtype, zooms=None, affine=None,
                  scl_slope: float = 1.0, scl_inter: float = 0.0) -> bytes:
    """The 352 header+extension bytes :func:`save` would write for a volume
    of this shape/dtype — lets a streaming writer (the serving daemon's
    volume endpoint) emit the header before any voxel data exists."""
    hdr = _header_bytes(tuple(int(s) for s in shape), np.dtype(dtype),
                        zooms, affine, scl_slope, scl_inter)
    return hdr + b"\x00" * 4


def _encode(data, zooms, affine, scl_slope, scl_inter):
    """Shared by save/save_bytes: (dtype-massaged data, header bytes)."""
    data = np.asarray(data)
    if data.dtype not in (np.uint8, np.int16, np.int32, np.float32, np.float64,
                          np.int8, np.uint16, np.uint32):
        data = data.astype(np.float32)
    return data, _header_bytes(data.shape, data.dtype, zooms, affine,
                               scl_slope, scl_inter)


def _header_bytes(shape, dtype, zooms, affine, scl_slope, scl_inter):
    ndim = len(shape)
    if ndim not in (2, 3, 4):
        raise ValueError(f"Expected 2D-4D data, got {ndim}D")
    code = _CODES[np.dtype(dtype)]
    bitpix = np.dtype(dtype).itemsize * 8

    dim = [ndim] + list(shape) + [1] * (7 - ndim)
    pixdim = [0.0] + list(zooms or ()) + [1.0] * 8
    pixdim = pixdim[:8]
    if affine is None:
        affine = np.diag(list(pixdim[1:4]) + [1.0])

    hdr = bytearray(HDR_SIZE)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<3f", hdr, 108, 352.0, float(scl_slope),
                     float(scl_inter))  # vox_offset, slope, inter
    descrip = _DESCRIP[:79]
    hdr[148:148 + len(descrip)] = descrip
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform 0, sform 1
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine[:3, :],
                                                   np.float32).ravel())
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr)
