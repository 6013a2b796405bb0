"""MDCT / IMDCT (modified DCT, the audio-codec lapped transform).

Beyond scipy.fft (which stops at DCT/DST I-IV); rides the framework's
DCT-IV through the standard TDAC folding identities, so the whole
transform is one DCT-IV plus O(n) folds:

    MDCT(x)_k  = sum_{t=0}^{2N-1} x_t cos[(pi/N)(t + 1/2 + N/2)(k + 1/2)]
               = DCT-IV([-rev(c) - d, a - rev(b)])_k / 2,
    IMDCT(X)_t = (1/N) sum_k X_k cos[...]
               = (1/(2N)) unfold(DCT-IV(X)),
    unfold(u1, u2) = [u2, -rev(u2), -rev(u1), -u1]

with (a, b, c, d) the input's length-N/2 quarters and (u1, u2) the
DCT-IV output halves (identities verified against the direct cosine sum
in tests/test_mdct.py).  Signal-level mdct/imdct use 50%-overlapped
frames with a Princen-Bradley window (default: sine), giving perfect
reconstruction (TDAC) in the interior; each call is one jitted program.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["mdct_frame", "imdct_frame", "mdct", "imdct", "sine_window"]


def sine_window(n2: int):
    """Princen-Bradley sine window of length 2N: w_t = sin(pi(t+1/2)/2N)
    (satisfies w_t^2 + w_{t+N}^2 = 1 -> perfect TDAC reconstruction)."""
    t = np.arange(n2, dtype=np.float64)
    return jnp.asarray(np.sin(math.pi * (t + 0.5) / n2), jnp.float32)


def mdct_frame(x):
    """MDCT of (windowed) frames [..., 2N] -> [..., N]."""
    from .dct import dct

    x = jnp.asarray(x, jnp.float32)
    n2 = x.shape[-1]
    if n2 % 4:
        raise ValueError(f"frame length must be a multiple of 4, got {n2}")
    q = n2 // 4
    a, b = x[..., :q], x[..., q: 2 * q]
    c, d = x[..., 2 * q: 3 * q], x[..., 3 * q:]
    u = jnp.concatenate(
        [-jnp.flip(c, -1) - d, a - jnp.flip(b, -1)], axis=-1)
    return dct(u, type=4) * 0.5


def imdct_frame(X):
    """IMDCT of [..., N] -> (aliased, unwindowed) frames [..., 2N]."""
    from .dct import dct

    X = jnp.asarray(X, jnp.float32)
    n = X.shape[-1]
    if n % 2:
        raise ValueError(f"coefficient length must be even, got {n}")
    v = dct(X, type=4) * jnp.float32(1.0 / (2 * n))
    u1, u2 = v[..., : n // 2], v[..., n // 2:]
    return jnp.concatenate(
        [u2, -jnp.flip(u2, -1), -jnp.flip(u1, -1), -u1], axis=-1)


def _frames(x, n):
    """[..., T] -> 50%-overlapped frames [..., T//N - 1, 2N] (T % N == 0)."""
    t = x.shape[-1]
    nf = t // n - 1
    idx = (np.arange(nf)[:, None] * n + np.arange(2 * n)[None, :])
    return x[..., idx], nf


def mdct(x, n: int, window=None):
    """Signal-level MDCT: real x [..., T] (T a multiple of N=n) ->
    coefficients [..., T/N - 1, N], 50%-overlapped sine-windowed frames
    (pass window=False for no window, or an array of length 2N)."""
    x = jnp.asarray(x, jnp.float32)
    if x.shape[-1] % n:
        raise ValueError(
            f"signal length {x.shape[-1]} must be a multiple of N={n}")
    w = sine_window(2 * n) if window is None else window

    @jax.jit
    def impl(v):
        fr, _ = _frames(v, n)
        if w is not False:
            return mdct_frame(fr * jnp.asarray(w, jnp.float32))
        return mdct_frame(fr)

    return impl(x)


def imdct(X, window=None):
    """Inverse of :func:`mdct` by windowed overlap-add (TDAC): X
    [..., F, N] -> real signal [..., (F+1)*N].  The first and last
    half-frames carry boundary aliasing (no neighbor to cancel it) —
    interior samples reconstruct exactly."""
    X = jnp.asarray(X, jnp.float32)
    n = X.shape[-1]
    nf = X.shape[-2]
    w = sine_window(2 * n) if window is None else window

    @jax.jit
    def impl(C):
        # the analysis/synthesis pair above reconstructs x/2 after OLA
        # (windowed TDAC sums (w_a^2 + w_c^2)/2 = 1/2); the standard
        # synthesis factor 2 restores unity gain
        y = imdct_frame(C) * 2.0  # [..., F, 2N]
        if w is not False:
            y = y * jnp.asarray(w, jnp.float32)
        t = (nf + 1) * n
        from .stft import _ola_slabs

        return _ola_slabs(y, n, t)  # scatter-free (flat scatters ~50x slower)

    return impl(X)
