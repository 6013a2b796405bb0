"""Twiddle-factor and DFT-matrix generation.

The reference precomputes its twiddle LUT on the host in f64 and casts to f32
before upload (fft_wgpu src/processor.rs:43-49).  We keep that accuracy
discipline: every trigonometric table here is generated in float64 (by the
native C++ helper when available, else numpy) and cast to float32 once.  The
tables are baked into the jitted executable as constants, so generation cost
is trace-time only.

Conventions
-----------
* ``sign = -1`` is the forward transform (``exp(-2*pi*i*k*n/N)``),
  ``sign = +1`` the inverse — matching numpy.fft and the reference
  (forward LUT processor.rs:46-48; inverse +theta ifft.wgsl:41-42).
* DFT matrix ``W[k, m] = exp(sign * 2*pi*i * k * m / n)`` is symmetric,
  so ``x @ W`` transforms the last axis.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils import native

__all__ = ["dft_matrix_np", "twiddle_np", "FORWARD", "INVERSE"]

FORWARD = -1
INVERSE = +1


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int, sign: int, dtype=np.float32):
    """(Wr, Wi) numpy arrays of shape [n, n]; W[k, m] = exp(sign*2pi*i*k*m/n).

    Generated in f64 (native C++ if built, numpy otherwise), cast to `dtype`.
    """
    tab = native.dft_matrix_f64(n, sign)
    if tab is None:
        k = np.arange(n, dtype=np.float64)
        theta = (sign * 2.0 * np.pi / n) * np.outer(k, k)
        tab = (np.cos(theta), np.sin(theta))
    wr, wi = tab
    return np.ascontiguousarray(wr, dtype=dtype), np.ascontiguousarray(wi, dtype=dtype)


@functools.lru_cache(maxsize=None)
def twiddle_np(n1: int, n2: int, sign: int, transposed: bool = False, dtype=np.float32):
    """Four-step inter-factor twiddles ``tw[k1, n2] = exp(sign*2pi*i*k1*n2/(n1*n2))``.

    ``transposed=True`` returns the [n2, k1] layout (for the recursion in
    ops/stockham.py, which twiddles the transposed row-matrix).
    """
    n = n1 * n2
    tab = native.twiddle_f64(n1, n2, sign)
    if tab is None:
        k1 = np.arange(n1, dtype=np.float64)
        m2 = np.arange(n2, dtype=np.float64)
        theta = (sign * 2.0 * np.pi / n) * np.outer(k1, m2)
        tab = (np.cos(theta), np.sin(theta))
    twr, twi = tab
    if transposed:
        twr, twi = twr.T, twi.T
    return np.ascontiguousarray(twr, dtype=dtype), np.ascontiguousarray(twi, dtype=dtype)


@functools.lru_cache(maxsize=None)
def halfcomplex_twiddle_np(n: int, sign: int, dtype=np.float32):
    """Twiddles exp(sign*2pi*i*k/n) for k = 0..n/2 (R2C/C2R recombination)."""
    m = n // 2
    k = np.arange(m + 1, dtype=np.float64)
    theta = (sign * 2.0 * np.pi / n) * k
    return (np.cos(theta).astype(dtype), np.sin(theta).astype(dtype))
