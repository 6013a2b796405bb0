"""Gradients through the chirp-z paths and the spectrum-product C2R.

Bluestein (ops/bluestein.py), the chirp-z transform (ops/czt.py) and the
fftconvolve epilogue (a spectrum product, then ops/rfft.irfft_last_split)
are compositions of elementwise chirps and plan-layer FFTs; jax.grad
through them is compared with jax.grad through a composed jnp.fft
implementation of the SAME linear map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _grads(fn, re, im, Wr, Wi):
    """grad of sum(Wr*Yr + Wi*Yi) wrt (re, im) — a full random-cotangent
    exercise of the transpose rule."""

    def loss(a, b):
        Yr, Yi = fn(a, b)
        return jnp.sum(Yr * Wr + Yi * Wi)

    return jax.grad(loss, argnums=(0, 1))(re, im)


def _close(got, want, tol, what):
    for g, w, part in zip(got, want, ("re", "im")):
        err = float(np.linalg.norm(np.asarray(g) - np.asarray(w))
                    / max(np.linalg.norm(np.asarray(w)), 1e-30))
        assert err < tol, f"{what} d{part}: rel {err:.3e} >= {tol}"


def _mk(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.float32)


@pytest.mark.parametrize("n,sign", [(521, -1), (521, +1), (1031, -1)])
def test_bluestein_grad(rng, n, sign):
    """jax.grad through the composed Bluestein (prime n) vs jnp.fft."""
    from fft_wgpu_tpu.ops.bluestein import fft_bluestein_split

    rows = 4
    re, im, Wr, Wi = (_mk(rng, rows, n) for _ in range(4))
    chirp = lambda a, b: fft_bluestein_split(a, b, sign)

    def composed(a, b):
        x = jax.lax.complex(a, b)
        X = jnp.fft.fft(x, axis=-1) if sign == -1 \
            else jnp.fft.ifft(x, axis=-1) * n
        return jnp.real(X), jnp.imag(X)

    _close(_grads(chirp, re, im, Wr, Wi),
           _grads(composed, re, im, Wr, Wi), 1e-4, f"bluestein {n}")
    _close(jax.jit(chirp)(re, im), composed(re, im), 1e-4,
           f"bluestein val {n}")


def test_czt_grad(rng):
    """jax.grad through czt (chirp, pad, FFT, filter, IFFT, chirp) vs the
    same z-transform as a dense complex matrix."""
    import fft_wgpu_tpu as ftt

    n, m = 96, 64
    w = np.exp(-2j * np.pi * 0.21 / m)
    a = np.exp(2j * np.pi * 0.03)
    k = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    M = (a ** (-j) * w ** (j * k)).astype(np.complex64)   # [m, n]
    re, im = _mk(rng, 3, n), _mk(rng, 3, n)
    Wr, Wi = _mk(rng, 3, m), _mk(rng, 3, m)

    def chirp(p, q):
        Z = ftt.czt(jax.lax.complex(p, q), m=m, w=w, a=a)
        return jnp.real(Z), jnp.imag(Z)

    def dense(p, q):
        Z = jnp.matmul(jax.lax.complex(p, q), jnp.asarray(M.T),
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.real(Z), jnp.imag(Z)

    _close(_grads(chirp, re, im, Wr, Wi),
           _grads(dense, re, im, Wr, Wi), 1e-4, "czt")


@pytest.mark.parametrize("n", [512, 511])
def test_prod_c2r_grad(rng, n):
    """real(IRFFT(A .* B)) — the fftconvolve epilogue — differentiated in
    all four operands vs the same map on jnp.fft."""
    from fft_wgpu_tpu.ops.rfft import irfft_last_split

    rows, bins = 4, n // 2 + 1
    Ar, Ai, Br, Bi = (_mk(rng, rows, bins) for _ in range(4))
    W = _mk(rng, rows, n)

    def loss(a, b, c, d):
        y = irfft_last_split(a * c - b * d, a * d + b * c, n, 1.0 / n)
        return jnp.sum(W * y)

    def loss_ref(a, b, c, d):
        pr = a * c - b * d
        pi = (a * d + b * c).at[..., 0].set(0.0)
        if n % 2 == 0:
            pi = pi.at[..., n // 2].set(0.0)
        return jnp.sum(W * jnp.fft.irfft(jax.lax.complex(pr, pi), n=n,
                                         axis=-1))

    gf = jax.grad(loss, argnums=(0, 1, 2, 3))(Ar, Ai, Br, Bi)
    gc = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(Ar, Ai, Br, Bi)
    for g1, g2, tag in zip(gf, gc, "abcd"):
        err = float(np.linalg.norm(np.asarray(g1) - np.asarray(g2))
                    / max(np.linalg.norm(np.asarray(g2)), 1e-30))
        assert err < 1e-4, f"prod-C2R grad d{tag}: {err:.3e}"
    err = abs(float(loss(Ar, Ai, Br, Bi)) - float(loss_ref(Ar, Ai, Br, Bi)))
    assert err < 1e-2


def test_public_prime_fft_grad(rng):
    """jax.grad through the PUBLIC prime-length fft vs jnp.fft."""
    import fft_wgpu_tpu as ftt

    rows, n = 4, 521
    re, im, Wr, Wi = (_mk(rng, rows, n) for _ in range(4))

    def public(a, b):
        X = ftt.fft(jax.lax.complex(a, b))
        return jnp.real(X), jnp.imag(X)

    def composed(a, b):
        X = jnp.fft.fft(jax.lax.complex(a, b), axis=-1)
        return jnp.real(X), jnp.imag(X)

    _close(_grads(public, re, im, Wr, Wi),
           _grads(composed, re, im, Wr, Wi), 1e-4, "public prime fft")
