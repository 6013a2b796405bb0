"""Chebyshev spectral methods on the DCT-I path: transforms between
values on Chebyshev-Gauss-Lobatto points and Chebyshev coefficients,
spectral differentiation, and Clenshaw-Curtis quadrature.

The non-periodic counterpart of ops/spectral.py (Trefethen, "Spectral
Methods in MATLAB", ch. 8): values at x_j = cos(pi j / n), j = 0..n,
relate to Chebyshev coefficients through a DCT-I, which this framework
evaluates through the batched R2C kernel (ops/dct.py).  Coefficient
recurrences (derivative, integral) are host-free jnp ops composed under
the caller's jit.

The reference library has no function-space layer at all (SURVEY §2);
this module backs non-periodic spectral PDE work the same way
ops/spectral.py backs the periodic models.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .dct import dct

__all__ = ["cheb_points", "cheb_coeffs", "cheb_values", "cheb_derivative",
           "clenshaw_curtis_weights", "cheb_integrate"]


def cheb_points(n: int, dtype=np.float32):
    """The n+1 Chebyshev-Gauss-Lobatto points x_j = cos(pi j / n),
    j = 0..n, in the standard descending order (x_0 = 1, x_n = -1)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    return jnp.asarray(np.cos(np.pi * np.arange(n + 1) / n).astype(dtype))


def cheb_coeffs(u, axis: int = -1):
    """Chebyshev coefficients a_k of values u at cheb_points(n) along
    `axis` (u has n+1 samples): u(x) = sum_k a_k T_k(x).

    Computed as a scaled DCT-I of the sample values.
    """
    u = jnp.moveaxis(jnp.asarray(u), axis, -1)
    n = u.shape[-1] - 1
    if n < 1:
        raise ValueError("need at least 2 samples")
    a = dct(u, type=1, axis=-1) / n
    ends = np.ones(n + 1, np.float32)
    ends[0] = 0.5
    ends[-1] = 0.5
    return jnp.moveaxis(a * ends, -1, axis)


def cheb_values(a, axis: int = -1):
    """Inverse of cheb_coeffs: evaluate the Chebyshev series with
    coefficients `a` at the n+1 Chebyshev points (DCT-I synthesis)."""
    a = jnp.moveaxis(jnp.asarray(a), axis, -1)
    n = a.shape[-1] - 1
    ends = np.ones(n + 1, np.float32)
    ends[0] = 2.0
    ends[-1] = 2.0
    u = dct(a * ends, type=1, axis=-1) * 0.5
    return jnp.moveaxis(u, -1, axis)


def _der_coeffs(a):
    """Coefficient recurrence b_k of the derivative of series a (last
    axis): b_{k} = b_{k+2} + 2 (k+1) a_{k+1}, b at or above n are 0,
    with the k = 0 halving.  Evaluated closed-form (scan-free) as
    b_k = sum_{j >= k+1, j-k odd} 2 j a_j via one [n+1, n+1] matmul,
    O(n^2) only in the tiny coefficient dimension.  The matmul runs at
    HIGHEST precision: a GPU's DEFAULT (TF32, ~1e-3 relative) would lose
    the spectral accuracy this is used for.
    """
    n = a.shape[-1] - 1
    k = np.arange(n + 1)
    j = np.arange(n + 1)
    M = ((j[None, :] > k[:, None]) & (((j[None, :] - k[:, None]) % 2) == 1)
         ).astype(np.float64) * (2.0 * j[None, :])
    M[0, :] *= 0.5
    return jnp.matmul(a, jnp.asarray(M.T.astype(np.float32)),
                      precision=jax.lax.Precision.HIGHEST)


def cheb_derivative(u, order: int = 1, axis: int = -1,
                    interval=(-1.0, 1.0)):
    """Spectral derivative of values `u` sampled at the n+1 Chebyshev
    points of `interval`, returned at the same points.

    Transforms to coefficient space (DCT-I), applies the derivative
    recurrence `order` times, and transforms back; the affine map from
    [-1, 1] to `interval` contributes (2/(b-a))^order.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    a, b = map(float, interval)
    scale = (2.0 / (b - a)) ** order

    def impl(v):
        c = cheb_coeffs(v, axis=-1)
        for _ in range(order):
            c = _der_coeffs(c)
        return cheb_values(c, axis=-1) * scale

    u = jnp.moveaxis(jnp.asarray(u), axis, -1)
    return jnp.moveaxis(jax.jit(impl)(u), -1, axis)


def clenshaw_curtis_weights(n: int, interval=(-1.0, 1.0)):
    """Clenshaw-Curtis quadrature weights for the n+1 Chebyshev points
    on `interval` (f64 host computation via the standard FFT identity;
    Trefethen ch. 12, `clencurt`)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    a, b = map(float, interval)
    # Trefethen, "Spectral Methods in MATLAB", clencurt.m (f64 host)
    theta = np.pi * np.arange(n + 1) / n
    w = np.zeros(n + 1)
    ii = np.arange(1, n)
    v = np.ones(n - 1)
    if n % 2 == 0:
        w[0] = w[n] = 1.0 / (n * n - 1)
        for k in range(1, n // 2):
            v -= 2.0 * np.cos(2.0 * k * theta[ii]) / (4.0 * k * k - 1)
        v -= np.cos(n * theta[ii]) / (n * n - 1)
    else:
        w[0] = w[n] = 1.0 / (n * n)
        for k in range(1, (n - 1) // 2 + 1):
            v -= 2.0 * np.cos(2.0 * k * theta[ii]) / (4.0 * k * k - 1)
    w[ii] = 2.0 * v / n
    return jnp.asarray(((b - a) / 2.0 * w).astype(np.float32))


def cheb_integrate(u, axis: int = -1, interval=(-1.0, 1.0)):
    """Clenshaw-Curtis integral of values `u` at the n+1 Chebyshev
    points of `interval` along `axis` (spectrally accurate for smooth
    integrands)."""
    u = jnp.asarray(u)
    w = clenshaw_curtis_weights(u.shape[axis] - 1, interval)
    # weights contract along `axis`
    return jnp.tensordot(u, w, axes=[[axis % u.ndim], [0]],
                         precision=jax.lax.Precision.HIGHEST)