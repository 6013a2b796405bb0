"""ctypes bridge to the native C++ core (``fft_wgpu_tpu/native/``).

The reference keeps its host/runtime layer in native code (Rust: plan
construction, f64 twiddle precompute — fft_wgpu src/processor.rs:43-49,
pipeline factories processor.rs:161-229).  Our equivalent is a small C++
library that owns the host-side numeric precompute (f64 DFT matrices /
twiddle tables), the mixed-radix factorization and the planar complex
codec.  It is built on demand
with g++; every entry point has a pure-numpy fallback so the framework works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
_SRC = os.path.join(_NATIVE_DIR, "src", "fftcore.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libfftcore.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-pthread", "-std=c++17", _SRC, "-o", _LIB],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not os.path.exists(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.fftcore_dft_matrix.argtypes = [
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.fftcore_twiddle.argtypes = [
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.fftcore_factorize.argtypes = [
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
            ]
            lib.fftcore_factorize.restype = ctypes.c_int64
            try:  # planar codec (absent in pre-codec builds of the .so)
                fp = ctypes.POINTER(ctypes.c_float)
                dp = ctypes.POINTER(ctypes.c_double)
                lib.fftcore_split_c64.argtypes = [fp, fp, fp,
                                                  ctypes.c_int64,
                                                  ctypes.c_int]
                lib.fftcore_split_c128.argtypes = [dp, fp, fp,
                                                   ctypes.c_int64,
                                                   ctypes.c_int]
                lib.fftcore_merge_c64.argtypes = [fp, fp, fp,
                                                  ctypes.c_int64,
                                                  ctypes.c_int]
            except AttributeError:
                pass
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dft_matrix_f64(n: int, sign: int):
    """f64 (cos, sin) [n, n] tables from the native core; None -> fallback."""
    lib = get_lib()
    if lib is None:
        return None
    wr = np.empty((n, n), dtype=np.float64)
    wi = np.empty((n, n), dtype=np.float64)
    lib.fftcore_dft_matrix(n, sign, _dptr(wr), _dptr(wi))
    return wr, wi


def twiddle_f64(n1: int, n2: int, sign: int):
    lib = get_lib()
    if lib is None:
        return None
    wr = np.empty((n1, n2), dtype=np.float64)
    wi = np.empty((n1, n2), dtype=np.float64)
    lib.fftcore_twiddle(n1, n2, sign, _dptr(wr), _dptr(wi))
    return wr, wi


def factorize(n: int, max_radix: int):
    """Mixed-radix factor schedule for n (largest-first), or None -> fallback."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(64, dtype=np.int64)
    cnt = lib.fftcore_factorize(n, max_radix, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 64)
    if cnt <= 0:
        return None
    return [int(v) for v in out[:cnt]]


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _codec_threads(n: int) -> int:
    if n < (1 << 20):
        return 1
    return min(8, os.cpu_count() or 1)


def host_split_complex(x: np.ndarray):
    """One-pass threaded interleaved->planar split of a host complex array:
    (re, im) float32 pair, or None without the native core.  The numpy
    fallback (x.real/x.imag copies) does two strided passes."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "fftcore_split_c64"):
        return None
    x = np.ascontiguousarray(x)
    re = np.empty(x.shape, np.float32)
    im = np.empty(x.shape, np.float32)
    n = x.size
    if x.dtype == np.complex64:
        lib.fftcore_split_c64(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _f32ptr(re), _f32ptr(im), n, _codec_threads(n))
    elif x.dtype == np.complex128:
        lib.fftcore_split_c128(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _f32ptr(re), _f32ptr(im), n, _codec_threads(n))
    else:
        return None
    return re, im


def host_merge_complex(re: np.ndarray, im: np.ndarray):
    """One-pass threaded planar->interleaved merge to complex64, or None
    without the native core (fallback: re + 1j*im, two passes + temps)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "fftcore_merge_c64"):
        return None
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    if re.shape != im.shape:
        return None
    z = np.empty(re.shape, np.complex64)
    n = z.size
    lib.fftcore_merge_c64(
        _f32ptr(re), _f32ptr(im),
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, _codec_threads(n))
    return z
