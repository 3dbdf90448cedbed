"""The port's own ctypes binding of the C++ PNG codec (native/png_loader.cpp).

The library is built at first use with ``make -C native`` into
``build/native/`` at the root of the checkout (the same Makefile the JAX
package's ``native.py`` runs; the target is moved out of the source
folder). Grayscale 8-bit PNGs are decoded and encoded by it, one file or
a threaded batch a call. Where it cannot be built or loaded, or a file is
one it does not take, the callers here use ``cv2``; which codec ran is
logged once. This is host I/O: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_SRC_DIR = _ROOT / "native"
LIB_PATH = _ROOT / "build" / "native" / "libmsrt_native.so"

logger = logging.getLogger("mri_superresolution_torch.native")
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_IP = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None if it cannot be."""
    if not LIB_PATH.exists():
        LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        # a name of this process's own, then an atomic rename: processes
        # that build at once never load a half-written library
        tmp = LIB_PATH.with_suffix(f".{os.getpid()}.so")
        try:
            subprocess.run(["make", "-C", str(_SRC_DIR), f"TARGET={tmp}"],
                           check=True, capture_output=True)
            os.replace(tmp, LIB_PATH)
        except (subprocess.CalledProcessError, OSError) as e:
            logger.info(f"native PNG codec not built ({e}); using cv2")
            return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError as e:
        logger.info(f"native PNG codec not loaded ({e}); using cv2")
        return None
    lib.msrt_decode_png.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_long,
                                    _IP, _IP]
    lib.msrt_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, _U8P, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.msrt_png_size.argtypes = [ctypes.c_char_p, _IP, _IP]
    lib.msrt_encode_png.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    for fn in (lib.msrt_decode_png, lib.msrt_decode_batch, lib.msrt_png_size,
               lib.msrt_encode_png):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _note(codec: str) -> None:
    logger.info(f"PNG codec: {codec}")


def png_size(path: str) -> Optional[tuple]:
    """(H, W) from the header, or None (no library, not a PNG it takes)."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.msrt_png_size(str(path).encode(), ctypes.byref(h),
                         ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def _native_decode(path: str) -> Optional[np.ndarray]:
    lib, size = get_lib(), png_size(path)
    if lib is None or size is None:
        return None
    out = np.empty(size, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.msrt_decode_png(str(path).encode(), out.ctypes.data_as(_U8P),
                           out.size, ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return out


def imread_gray(path: str) -> np.ndarray:
    """One grayscale PNG as (H, W) uint8: the native codec, else cv2."""
    img = _native_decode(path)
    if img is not None:
        _note("native")
        return img
    import cv2
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise RuntimeError(f"Error loading image at path: {path}")
    _note("cv2")
    return img


def decode_batch(paths: List[str], item_hw: tuple,
                 n_threads: int = 0) -> Optional[np.ndarray]:
    """Same-sized grayscale PNGs into one (N, H, W) uint8 array with the
    native thread pool; None on any failure (callers decode one by one)."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    n_threads = n_threads or min(os.cpu_count() or 1, 8)
    h, w = item_hw
    out = np.empty((len(paths), h, w), np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    if lib.msrt_decode_batch(arr, len(paths), out.ctypes.data_as(_U8P), h, w,
                             n_threads) != 0:
        return None
    _note("native")
    return out


def imwrite_gray(path: str, img: np.ndarray) -> None:
    """Write one (H, W) uint8 grayscale PNG: the native encoder (filter-None
    rows, stored deflate blocks), else cv2."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"a grayscale image is (H, W), got {img.shape}")
    lib = get_lib()
    if lib is not None and lib.msrt_encode_png(
            str(path).encode(), img.ctypes.data_as(_U8P), img.shape[0],
            img.shape[1], 0) == 0:
        _note("native")
        return
    import cv2
    if not cv2.imwrite(str(path), img):
        raise RuntimeError(f"Error writing image at path: {path}")
    _note("cv2")
