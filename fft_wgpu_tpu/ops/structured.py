"""FFT-based structured linear algebra: circulant and Toeplitz operators.

Circulant matrices diagonalize in the Fourier basis, so matvec and solve
are O(n log n) spectral multiplies; Toeplitz matvecs ride a circulant
embedding of twice the length; symmetric positive-definite Toeplitz
solves use conjugate gradients with the Strang circulant preconditioner
(every iteration is FFT matvecs — the classic superfast-Toeplitz recipe,
all of it batched here).  Circulant embedding also yields exact
stationary Gaussian-random-field sampling (Dietrich & Newsam 1997).

    circulant_matvec(c, x)     y = C(c) @ x            O(n log n)
    circulant_solve(c, b)      x = C(c)^{-1} b         spectral division
    toeplitz_matvec(c, r, x)   y = T(c, r) @ x         circulant embedding
    toeplitz_solve(c, b)       SPD T(c, c) solve       PCG + Strang
    grf_sample(acf, key)       exact stationary GRF    Dietrich-Newsam

Everything traces into one jitted program per shape; inputs/outputs are
real f32 (complex spectra never cross the host boundary).  The reference
has no linear-algebra layer (bare C2C FFT library, SURVEY §1); oracles
are scipy.linalg.{circulant,toeplitz,solve_toeplitz}.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.twiddle import FORWARD, INVERSE

__all__ = ["circulant_matvec", "circulant_solve", "toeplitz_matvec",
           "bccb_matvec", "bccb_solve",
           "toeplitz_solve", "grf_sample"]


def _fft_last(re, im, sign, scale):
    from .nd import fftn_split

    return fftn_split(re, im, (re.ndim - 1,), sign, scale)


def circulant_matvec(c, x):
    """y = C @ x where C = scipy.linalg.circulant(c): C[i, j] = c[(i-j) % n].
    `x` may carry leading batch dims [..., n]."""
    c = jnp.asarray(c, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    if c.ndim != 1 or x.shape[-1] != c.shape[0]:
        raise ValueError(f"c must be 1-D with x.shape[-1] == len(c); "
                         f"got {c.shape} vs {x.shape}")
    return _circ_matvec_impl(c, x)


@jax.jit
def _circ_matvec_impl(c, x):
    n = c.shape[-1]
    Cr, Ci = _fft_last(c, jnp.zeros_like(c), FORWARD, None)
    Xr, Xi = _fft_last(x, jnp.zeros_like(x), FORWARD, None)
    yr, _ = _fft_last(Xr * Cr - Xi * Ci, Xr * Ci + Xi * Cr,
                      INVERSE, 1.0 / n)
    return yr


def circulant_solve(c, b):
    """x with C(c) @ x = b by spectral division (batched over leading dims
    of `b`).  C must be invertible: a vanishing Fourier eigenvalue of `c`
    makes the system singular (no pseudo-inverse fallback is applied)."""
    c = jnp.asarray(c, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    if c.ndim != 1 or b.shape[-1] != c.shape[0]:
        raise ValueError(f"c must be 1-D with b.shape[-1] == len(c); "
                         f"got {c.shape} vs {b.shape}")
    return _circ_solve_impl(c, b)


@jax.jit
def _circ_solve_impl(c, b):
    n = c.shape[-1]
    Cr, Ci = _fft_last(c, jnp.zeros_like(c), FORWARD, None)
    Br, Bi = _fft_last(b, jnp.zeros_like(b), FORWARD, None)
    d = Cr * Cr + Ci * Ci
    xr, _ = _fft_last((Br * Cr + Bi * Ci) / d, (Bi * Cr - Br * Ci) / d,
                      INVERSE, 1.0 / n)
    return xr


def _toeplitz_embedding(c, r):
    """First column of the length-2n circulant that embeds T(c, r)."""
    n = c.shape[0]
    pad = jnp.zeros((1,), c.dtype)
    return jnp.concatenate([c, pad, r[1:][::-1]])  # length 2n


def toeplitz_matvec(c, r, x):
    """y = T @ x where T = scipy.linalg.toeplitz(c, r) (square: first
    column `c`, first row `r`, r[0] is taken from c[0]).  Batched over
    leading dims of `x`.  Uses a 2n circulant embedding."""
    c = jnp.asarray(c, jnp.float32)
    r = jnp.asarray(r, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    if c.ndim != 1 or r.ndim != 1 or c.shape != r.shape:
        raise ValueError("c and r must be 1-D of equal length")
    if x.shape[-1] != c.shape[0]:
        raise ValueError(f"x.shape[-1] must equal len(c) == {c.shape[0]}")
    return _toep_matvec_impl(c, r, x)


@jax.jit
def _toep_matvec_impl(c, r, x):
    n = c.shape[0]
    emb = _toeplitz_embedding(c, r)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n)])
    return _circ_matvec_impl(emb, xp)[..., :n]


def toeplitz_solve(c, b, *, tol: float = 1e-6, max_iter: int | None = None):
    """Solve T x = b for a symmetric positive-definite Toeplitz T whose
    first column is `c` (scipy.linalg.solve_toeplitz(c, b) parity for the
    SPD case), via conjugate gradients with the Strang circulant
    preconditioner — every iteration is two FFT matvecs, O(n log n).
    Batched over leading dims of `b`; iterates until the preconditioned
    residual norm falls below tol * ||b|| (or max_iter, default 4n)."""
    c = jnp.asarray(c, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    if c.ndim != 1 or b.shape[-1] != c.shape[0]:
        raise ValueError(f"c must be 1-D with b.shape[-1] == len(c); "
                         f"got {c.shape} vs {b.shape}")
    n = int(c.shape[0])
    if max_iter is None:
        max_iter = 4 * n
    # Strang preconditioner: the circulant nearest to T — copy the central
    # diagonals, wrap them periodically (f64 host table, cast once)
    ch = np.asarray(c, np.float64)
    s = ch.copy()
    half = n // 2
    s[n - half:] = ch[1:half + 1][::-1] if half >= 1 else s[n - half:]
    return _toep_pcg_impl(c, jnp.asarray(s, jnp.float32), b,
                          jnp.float32(tol), max_iter)


@partial(jax.jit, static_argnums=(4,))
def _toep_pcg_impl(c, s, b, tol, max_iter):
    matvec = lambda v: _toep_matvec_impl(c, c, v)
    precond = lambda v: _circ_solve_impl(s, v)

    def dot(u, v):
        return jnp.sum(u * v, axis=-1, keepdims=True)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    target = tol * jnp.sqrt(dot(b, b))

    def cond(state):
        i, _, r, _, _ = state
        return jnp.logical_and(
            i < max_iter,
            jnp.any(jnp.sqrt(jnp.max(dot(r, r))) > jnp.min(target)))

    def body(state):
        i, x, r, z, p = state
        Ap = matvec(p)
        rz = dot(r, z)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r2 = r - alpha * Ap
        z2 = precond(r2)
        beta = dot(r2, z2) / rz
        return i + 1, x, r2, z2, z2 + beta * p

    _, x, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, r0, z0, z0))
    return x


def grf_sample(acf, key, num: int = 1):
    """Exact stationary Gaussian random field samples on a regular 1-D
    grid by circulant embedding (Dietrich & Newsam 1997).

    `acf[k]` is the autocovariance at lag k (length n).  Returns
    [num, n] real samples whose exact covariance is toeplitz(acf),
    provided the minimal 2(n-1) embedding is nonnegative-definite (true
    for e.g. exponential and Gaussian covariances); raises otherwise.
    """
    acf = np.asarray(acf, np.float64)
    if acf.ndim != 1 or acf.size < 2:
        raise ValueError("acf must be 1-D with at least 2 lags")
    n = acf.size
    emb = np.concatenate([acf, acf[1:-1][::-1]])     # length m = 2(n-1)
    lam = np.fft.fft(emb).real
    if lam.min() < -1e-8 * lam.max():
        raise ValueError(
            "circulant embedding is not nonnegative definite; taper the "
            f"acf or pad it further (min eigenvalue {lam.min():.3e})")
    lam = np.maximum(lam, 0.0)
    m = emb.size
    sqrt_lam = jnp.asarray(np.sqrt(lam / m), jnp.float32)
    return _grf_impl(sqrt_lam, key, num, n)


@partial(jax.jit, static_argnums=(2, 3))
def _grf_impl(sqrt_lam, key, num, n):
    m = sqrt_lam.shape[0]
    k1, k2 = jax.random.split(key)
    # complex normal with unit variance per part; real/imag slices of the
    # synthesized field are two independent exact samples — interleave
    # them across the requested batch
    pairs = (num + 1) // 2
    er = jax.random.normal(k1, (pairs, m), jnp.float32)
    ei = jax.random.normal(k2, (pairs, m), jnp.float32)
    fr, fi = _fft_last(er * sqrt_lam, ei * sqrt_lam, FORWARD, None)
    out = jnp.concatenate([fr[:, :n], fi[:, :n]], axis=0)
    return out[:num]


def _fft2_last(re, im, sign, scale):
    from .nd import fftn_split

    return fftn_split(re, im, (re.ndim - 2, re.ndim - 1), sign, scale)


def bccb_matvec(k, x):
    """y = B @ vec(x) where B is the block-circulant-with-circulant-
    blocks (BCCB) matrix generated by the 2-D kernel `k` — i.e. the 2-D
    CIRCULAR convolution of x [.., m, n] with k [m, n] (the structure of
    periodic-boundary image blurring).  Diagonalized by the 2-D DFT:
    y = ifft2(fft2(k) * fft2(x))."""
    k = jnp.asarray(k, jnp.float32)
    x = jnp.asarray(x, jnp.float32)
    if k.ndim != 2 or x.shape[-2:] != k.shape:
        raise ValueError(f"k must be 2-D with x.shape[-2:] == k.shape; "
                         f"got {k.shape} vs {x.shape}")
    return _bccb_matvec_impl(k, x)


@jax.jit
def _bccb_matvec_impl(k, x):
    total = k.shape[-2] * k.shape[-1]
    Kr, Ki = _fft2_last(k, jnp.zeros_like(k), FORWARD, None)
    Xr, Xi = _fft2_last(x, jnp.zeros_like(x), FORWARD, None)
    yr, _ = _fft2_last(Xr * Kr - Xi * Ki, Xr * Ki + Xi * Kr, INVERSE,
                       1.0 / total)
    return yr


def bccb_solve(k, b, *, reg: float = 0.0):
    """x with B(k) @ vec(x) = vec(b) by 2-D spectral division — periodic
    deconvolution.  `reg` adds Tikhonov regularization
    (B^T B + reg I)^{-1} B^T b, the standard Wiener-style deblur for
    kernels with vanishing frequency response (reg=0 is the exact
    inverse and requires all eigenvalues nonzero)."""
    k = jnp.asarray(k, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    if k.ndim != 2 or b.shape[-2:] != k.shape:
        raise ValueError(f"k must be 2-D with b.shape[-2:] == k.shape; "
                         f"got {k.shape} vs {b.shape}")
    return _bccb_solve_impl(k, b, float(reg))


@partial(jax.jit, static_argnums=(2,))
def _bccb_solve_impl(k, b, reg):
    total = k.shape[-2] * k.shape[-1]
    Kr, Ki = _fft2_last(k, jnp.zeros_like(k), FORWARD, None)
    Br, Bi = _fft2_last(b, jnp.zeros_like(b), FORWARD, None)
    d = Kr * Kr + Ki * Ki + reg
    # conj(K) * B / (|K|^2 + reg)
    xr, _ = _fft2_last((Br * Kr + Bi * Ki) / d, (Bi * Kr - Br * Ki) / d,
                       INVERSE, 1.0 / total)
    return xr
