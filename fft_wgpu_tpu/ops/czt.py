"""Chirp-Z transform and zoom FFT (scipy.signal-compatible).

The generalization of ops/bluestein.py: evaluate the z-transform on an
arbitrary logarithmic spiral  z_k = a * w^{-k}, k = 0..m-1:

    X[k] = sum_j x[j] * a^{-j} * w^{jk}

via the chirp factorization w^{jk} = w^{(j^2 + k^2 - (k-j)^2)/2} and one
power-of-two FFT convolution.  All chirp tables are generated on the host
in complex128 (with quadratic-index modular reduction where applicable).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge, promote_to_split

__all__ = ["czt", "zoom_fft", "CZT", "ZoomFFT", "czt_points"]


@functools.lru_cache(maxsize=None)
def _czt_tables(n: int, m: int, w: complex, a: complex):
    """(A, Wk, Vf, L): input chirp [n], output chirp [m], filter spectrum [L]."""
    j = np.arange(max(n, m), dtype=np.float64)
    # chirp exponents j^2/2 can overflow the phase; use complex128 pow of
    # the PHASE instead: w = rho*exp(i*phi): w^(j^2/2) computed via exp.
    logw = np.log(complex(w))
    loga = np.log(complex(a))
    jn = np.arange(n, dtype=np.float64)
    jm = np.arange(m, dtype=np.float64)
    A = np.exp(-jn * loga + (jn**2 / 2.0) * logw)        # a^{-j} w^{j^2/2}
    Wk = np.exp((jm**2 / 2.0) * logw)                    # w^{k^2/2}
    L = 1 << int(np.ceil(np.log2(n + m - 1)))
    t = np.zeros(L, dtype=np.complex128)
    idx = np.arange(m, dtype=np.float64)
    t[:m] = np.exp(-(idx**2 / 2.0) * logw)               # v[t] = w^{-t^2/2}
    tail = np.arange(1, n, dtype=np.float64)
    t[L - (n - 1):] = np.exp(-(tail[::-1] ** 2 / 2.0) * logw)
    Vf = np.fft.fft(t)
    f32 = lambda z: (z.real.astype(np.float32), z.imag.astype(np.float32))
    return f32(A), f32(Wk), f32(Vf), L


def czt(x, m: int | None = None, w: complex | None = None,
        a: complex = 1 + 0j, *, axis: int = -1):
    """Chirp-Z transform along `axis` (scipy.signal.czt semantics).

    Defaults (m=n, w=exp(-2j*pi/m)) reduce to the DFT.
    """
    re, im = promote_to_split(x)
    n = re.shape[axis]
    m = m or n
    if w is None:
        w = np.exp(-2j * np.pi / m)
    m = int(m)
    (Ar, Ai), (Wr, Wi), (Vr, Vi), L = _czt_tables(n, m, complex(w), complex(a))
    from ..plan.plan import get_plan

    p = get_plan(L, "auto")
    Ar, Ai, Wr, Wi, Vr, Vi = map(jnp.asarray, (Ar, Ai, Wr, Wi, Vr, Vi))

    def impl(re, im):
        re = jnp.moveaxis(re, axis, -1)
        im = jnp.moveaxis(im, axis, -1)
        yr = re * Ar - im * Ai
        yi = re * Ai + im * Ar
        pad = [(0, 0)] * (yr.ndim - 1) + [(0, L - n)]
        yr = jnp.pad(yr, pad)
        yi = jnp.pad(yi, pad)
        Yr, Yi = p._execute_split(yr, yi, -1, None)
        Pr = Yr * Vr - Yi * Vi
        Pi = Yr * Vi + Yi * Vr
        gr, gi = p._execute_split(Pr, Pi, +1, 1.0 / L)
        gr = gr[..., :m]
        gi = gi[..., :m]
        outr = gr * Wr - gi * Wi
        outi = gr * Wi + gi * Wr
        return (
            jnp.moveaxis(outr, -1, axis),
            jnp.moveaxis(outi, -1, axis),
        )

    rr, ii = jax.jit(impl)(re, im)
    return merge(rr, ii)


def _zoom_params(fn, m: int, fs: float, endpoint: bool):
    """(f1, f2, w, a) for a zoomed DFT over the band `fn` (scipy
    zoom_fft/ZoomFFT shared derivation)."""
    if np.isscalar(fn):
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = map(float, fn)
    k = (m - 1) if endpoint else m
    w = np.exp(-2j * np.pi * (f2 - f1) / (k * fs)) if k > 0 else 1 + 0j
    a = np.exp(2j * np.pi * f1 / fs)
    return f1, f2, w, a


def zoom_fft(x, fn, m: int | None = None, *, fs: float = 2.0,
             endpoint: bool = False, axis: int = -1):
    """Zoomed DFT over the band [f1, f2] (scipy.signal.zoom_fft semantics:
    `fn` is [f1, f2] or f2 with f1=0; `endpoint` includes f2 as the last
    sample)."""
    re, _ = promote_to_split(x)
    n = re.shape[axis]
    m = m or n
    _f1, _f2, w, a = _zoom_params(fn, int(m), fs, endpoint)
    return czt(x, m=m, w=w, a=a, axis=axis)


def czt_points(m: int, w: complex | None = None, a: complex = 1 + 0j):
    """The m z-plane points a * w^{-k} a CZT evaluates at
    (scipy.signal.czt_points parity; complex128 on the host)."""
    m = int(m)
    if w is None:
        w = np.exp(-2j * np.pi / m)
    k = np.arange(m, dtype=np.float64)
    return complex(a) * np.exp(-k * np.log(complex(w)))


class CZT:
    """Plan-style chirp-Z transform (scipy.signal.CZT parity).

    Construct once per (n, m, w, a); calling replays the cached jitted
    program — the same build-once/execute-many contract as `plan.Plan`
    (reference Forward::new / proc, fft_wgpu src/processor.rs:7-159).
    """

    def __init__(self, n: int, m: int | None = None,
                 w: complex | None = None, a: complex = 1 + 0j):
        self.n = int(n)
        self.m = int(m or n)
        if w is None:
            w = np.exp(-2j * np.pi / self.m)
        self.w = complex(w)
        self.a = complex(a)

    def __call__(self, x, *, axis: int = -1):
        re, _ = promote_to_split(x)
        if re.shape[axis] != self.n:
            raise ValueError(
                f"CZT planned for length {self.n}, got {re.shape[axis]}")
        return czt(x, m=self.m, w=self.w, a=self.a, axis=axis)

    def points(self):
        """The z-plane points this transform evaluates at."""
        return czt_points(self.m, self.w, self.a)


class ZoomFFT(CZT):
    """Plan-style zoomed DFT over a frequency band
    (scipy.signal.ZoomFFT parity): CZT specialized to the unit circle
    between f1 and f2 at sample rate fs."""

    def __init__(self, n: int, fn, m: int | None = None, *,
                 fs: float = 2.0, endpoint: bool = False):
        n = int(n)
        m = int(m or n)
        f1, f2, w, a = _zoom_params(fn, m, fs, endpoint)
        super().__init__(n, m, w, a)
        self.f1, self.f2, self.fs = f1, f2, float(fs)
