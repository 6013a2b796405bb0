"""Bluestein (chirp-z) FFT for lengths with large prime factors.

The reference supports powers of two only (stage count = log2(fft_len),
fft_wgpu src/processor.rs:327).  Mixed-radix covers smooth n; this module
covers the rest: any n becomes two power-of-two FFTs of length
m >= 2n-1 via the chirp-z identity

    X[k] = conj(c[k]) * IFFT( FFT(conj(c)*x, m) * FFT(b, m) )[k],
    c[j] = exp(+i*pi*j^2/n),  b[j] = c[j] for |j| < n (wrapped)

with the chirp tables generated in f64 on the host (j^2 mod 2n reduction,
so precision holds at large n).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

__all__ = ["fft_bluestein_split", "BLUESTEIN_MIN"]

# below this, the recursion (ops/stockham.py) uses one direct O(n^2) DFT matmul
BLUESTEIN_MIN = 512


@functools.lru_cache(maxsize=None)
def _chirp_np(n: int, sign: int):
    """(c_re, c_im, Bf_re, Bf_im, m): chirp c[j]=exp(sign*i*pi*j^2/n) and
    the precomputed FFT of the wrapped conjugate-chirp filter b, length m."""
    m = 1 << int(np.ceil(np.log2(2 * n - 1)))
    j = np.arange(n, dtype=np.int64)
    # j^2 mod 2n keeps the f64 phase argument small at large n
    phase = (np.pi / n) * ((j * j) % (2 * n)).astype(np.float64)
    c = np.cos(phase) + 1j * np.sin(phase)  # exp(+i*pi*j^2/n)
    if sign == -1:
        c = np.conj(c)  # forward chirp is exp(-i*pi*j^2/n)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c)[1:][::-1]
    Bf = np.fft.fft(b)
    return (
        c.real.astype(np.float32),
        c.imag.astype(np.float32),
        Bf.real.astype(np.float32),
        Bf.imag.astype(np.float32),
        m,
    )


def fft_bluestein_split(re, im, sign, scale=None):
    """Chirp-z DFT over the last axis of a split (re, im) pair (any n)."""
    from ..plan.plan import get_plan
    from .stockham import apply_scale

    n = re.shape[-1]
    cr, ci, bfr, bfi, m = _chirp_np(n, sign)

    cr = jnp.asarray(cr)
    ci = jnp.asarray(ci)
    bfr = jnp.asarray(bfr)
    bfi = jnp.asarray(bfi)

    # a = c * x, zero-padded to m
    ar = re * cr - im * ci
    ai = re * ci + im * cr
    pad = [(0, 0)] * (re.ndim - 1) + [(0, m - n)]
    ar = jnp.pad(ar, pad)
    ai = jnp.pad(ai, pad)

    p = get_plan(m, "auto")
    Ar, Ai = p._execute_split(ar, ai, -1, None)
    # pointwise multiply with the filter spectrum
    Pr = Ar * bfr - Ai * bfi
    Pi = Ar * bfi + Ai * bfr
    yr, yi = p._execute_split(Pr, Pi, +1, 1.0 / m)

    yr = yr[..., :n]
    yi = yi[..., :n]
    out_r = yr * cr - yi * ci
    out_i = yr * ci + yi * cr
    return apply_scale(out_r, out_i, scale)
