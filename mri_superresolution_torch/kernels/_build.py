"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library under
``build/torch_kernels/`` at the root of the checkout. The library's name
carries a hash of the sources and flags, so an edited source is rebuilt at
its first use and an unchanged one is loaded as it is. The library has a
plain C interface and is loaded with ``ctypes``: pointers and the stream
pass as ``c_void_p``, and every entry returns the launch's
``cudaGetLastError()``, which :func:`check` turns into an exception. A
build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# argtypes of every C entry point in csrc/
SIGNATURES = {
    "msr_gn_leaky_fwd": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I,
                         _I, _I, _F, _F, _P],
    "msr_gn_leaky_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                         _LL, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "msr_gn_onepass_capacity": [_PI, _PI],
    "msr_gn_onepass_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                           _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "msr_gn_onepass_bwd_capacity": [_PI, _PI],
    "msr_gn_onepass_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I,
                           _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "msr_conv3x3_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "msr_conv3x3_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "msr_ssim_capacity": [_I, _PI, _PI],
    "msr_ssim_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _F, _F, _F, _P],
    "msr_leaky_quantize": [_P, _P, _P, _LL, _I, _I, _I, _F, _P],
    "msr_leaky_quantize_stream": [_P, _P, _P, _LL, _I, _F, _P],
    "msr_probe_copy": [_P, _P, _I, _I, _P],
    "msr_probe_roll32": [_P, _P, _I, _I, _P],
    "msr_probe_taps3": [_P, _P, _I, _I, _P],
    "msr_bias_epilogue": [_P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
    "msr_window_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    "msr_padded_layer_norm": [_P, _P, _P, _P, _LL, _I, _I, _F, _P],
    "msr_swin_mlp": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmsr_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile every source (in parallel) and link the library, unless a
    library of the same sources exists. Returns its path; the compiler's
    output, ptxas's register and spill report and each source's compile
    seconds included, is kept in ``build.log`` beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tag = f"{lib.stem}.{os.getpid()}"

    def compile_one(src: Path):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        t0 = time.perf_counter()
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                           capture_output=True, text=True)
        return src, obj, r, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cus)) as pool:
        results = list(pool.map(compile_one, cus))
    log = []
    for src, _, r, sec in results:
        log.append(f"== {src.name} (rc {r.returncode}, {sec:.1f} s)\n"
                   f"{r.stdout}{r.stderr}")
    failed = [src.name for src, _, r, _ in results if r.returncode != 0]
    if not failed:
        tmp = BUILD_DIR / f"{tag}.so"
        r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                            *[str(o) for _, o, _, _ in results]],
                           capture_output=True, text=True)
        log.append(f"== link (rc {r.returncode})\n{r.stdout}{r.stderr}")
        if r.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib)
    for _, obj, _, _ in results:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    (BUILD_DIR / "build.log").write_text(text)
    if failed:
        raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):"
                           f"\n{text[-6000:]}")
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library, loaded once per process, with every entry's
    argtypes and restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.msr_error_string.argtypes = [ctypes.c_int]
    lib.msr_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().msr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def device_index(device) -> int:
    import torch
    return device.index if device.index is not None else \
        torch.cuda.current_device()


# arrival counters of the kernels that end in a cross-block step (B1's
# one-pass kernels, B2), one int32 buffer a device and kernel; every launch
# leaves them at zero. A buffer replaced by a larger one is kept: a
# captured CUDA graph may still point at it.
_COUNTERS: dict = {}
_RETIRED: list = []
_MIN_COUNTERS = 1024


def counters(device, n: int, what: str):
    """At least ``n`` counters on ``device`` for the kernel named ``what``,
    zero between launches. One buffer a device and name, so two launches
    of one kernel must not run at once on two streams of one device (the
    port runs one stream). Made with torch.zeros outside any CUDA graph
    capture: call the wrapper once, at the largest batch, before capturing
    it."""
    import torch
    key = (device_index(device), what)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what}: call it once outside CUDA graph "
                               f"capture at this batch size first (its "
                               f"counters are made then)")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, _MIN_COUNTERS), dtype=torch.int32,
                          device=device)
        _COUNTERS[key] = buf
    return buf


def channels_last(t) -> bool:
    """Whether the 4-D ``t`` is channels_last contiguous: the tensor's own
    flag. While ``torch.export`` traces with a symbolic batch, the flag of
    a fake tensor that a CUDA meta function made can read False for
    channels_last strides (the unet's first GroupNorm input, on an H100),
    so there its strides decide, size-1 dimensions skipped as the flag
    skips them."""
    import torch
    if t.is_contiguous(memory_format=torch.channels_last):
        return True
    if not torch.compiler.is_compiling():
        return False
    _, c, h, w = t.shape
    want = (h * w * c, 1, w * c, c)
    return all(s == e or n == 1
               for s, e, n in zip(t.stride(), want, t.shape))


def needs_grad(*tensors) -> bool:
    """Whether autograd will differentiate a call on ``tensors`` (None
    entries allowed): grad mode on and one of them requires grad. A
    wrapper then runs as its ``torch.autograd.Function``; otherwise it
    calls its kernel directly and saves nothing for a backward."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
