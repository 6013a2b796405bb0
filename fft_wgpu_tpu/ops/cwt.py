"""Continuous wavelet transform, FFT-accelerated across all scales.

    cwt(x, widths, wavelet="ricker")  ->  [len(widths), len(x)]

scipy.signal.cwt semantics (removed from scipy 1.15; this is its
replacement here): row i is `convolve(x, wavelet(N_i, w_i)[::-1].conj(),
mode="same")` with N_i = min(10*w_i, len(x)).  Instead of one direct
convolution per scale, the whole filter bank is zero-padded to a common
FFT length and applied as ONE batched spectral multiply: a single
forward transform of the signal, a [W, nfft] batched wavelet transform,
and one batched inverse — everything in one jitted program riding the
framework's batched transforms (the batched formulation of what scipy
looped in Python).

Wavelets: `ricker` (Mexican hat, real) and `morlet2` (complex Morlet,
scipy conventions); or pass any callable wavelet(points, width) ->
np.ndarray (real or complex, f64 — tables are f64-generated then cast
once, per the framework invariant).

The reference has no wavelet layer (bare C2C FFT library, SURVEY §1).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge
from ..core.twiddle import FORWARD, INVERSE

__all__ = ["cwt", "CWT", "ricker", "morlet2"]


def ricker(points: int, a: float) -> np.ndarray:
    """Mexican-hat (Ricker) wavelet, scipy.signal.ricker parity (f64)."""
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25)
    vec = np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0
    xsq = (vec / a) ** 2
    return A * (1.0 - xsq) * np.exp(-xsq / 2.0)


def morlet2(points: int, s: float, w: float = 5.0) -> np.ndarray:
    """Complex Morlet wavelet, scipy.signal.morlet2 parity (c128)."""
    x = (np.arange(points, dtype=np.float64) - (points - 1.0) / 2.0) / s
    return (np.exp(1j * w * x) * np.exp(-0.5 * x ** 2)
            * np.pi ** -0.25 * np.sqrt(1.0 / s))


_WAVELETS = {"ricker": ricker, "morlet2": morlet2}


def _build_bank(n, widths, wavelet, w):
    """Host-side f64 bank, zero-padded to the longest kernel (cast once)."""
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    if widths.ndim != 1 or widths.size == 0:
        raise ValueError("widths must be a non-empty 1-D sequence")
    if callable(wavelet):
        gen = wavelet
    else:
        try:
            gen = _WAVELETS[wavelet]
        except KeyError:
            raise ValueError(
                f"unknown wavelet {wavelet!r}; expected one of "
                f"{sorted(_WAVELETS)} or a callable") from None
    if w is not None:
        gen = partial(gen, w=w)
    lengths = [min(max(int(10 * wd), 1), n) for wd in widths]
    lmax = max(lengths)
    bank = np.zeros((len(widths), lmax), np.complex128)
    cplx = False
    for i, (wd, li) in enumerate(zip(widths, lengths)):
        wl = np.conj(np.asarray(gen(li, wd))[::-1])
        cplx |= np.iscomplexobj(wl)
        # place each reversed kernel so the common 'same' slice at
        # (lmax-1)//2 lands on that kernel's own (li-1)//2 start
        off = (lmax - 1) // 2 - (li - 1) // 2
        bank[i, off:off + li] = wl
    return bank, lmax, cplx


def _pick_nfft(lfull: int) -> int:
    """Transform length: the next 5-smooth length (next_fast_len)."""
    from .helpers import next_fast_len

    return next_fast_len(lfull)


def cwt(x, widths, wavelet="ricker", *, w: float | None = None):
    """CWT of real 1-D `x` over `widths`; returns [len(widths), len(x)],
    real for real wavelets, complex (device-side) for complex ones —
    move complex results with `device_get_complex`.  `w` is the Morlet
    center frequency (scipy's `w`, default 5).

    For replay loops over many signals build a :class:`CWT` plan — it
    precomputes the bank SPECTRUM once, so each apply is one signal
    transform plus a single fused bank pass."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 1:
        raise ValueError("cwt expects a 1-D signal")
    n = int(x.shape[0])
    bank, lmax, cplx = _build_bank(n, widths, wavelet, w)
    nfft = _pick_nfft(n + lmax - 1)
    br = jnp.asarray(bank.real, jnp.float32)
    bi = jnp.asarray(bank.imag, jnp.float32)
    rr, ri = _cwt_impl(x, br, bi, nfft, n, lmax)
    return merge(rr, ri) if cplx else rr


class CWT:
    """Plan-style CWT: the filter-bank SPECTRUM is computed once at
    build; each `apply(x)` is one small signal transform, the per-scale
    spectral multiply and one bank-sized inverse transform."""

    def __init__(self, n: int, widths, wavelet="ricker", *,
                 w: float | None = None):
        self.n = int(n)
        bank, self._lmax, self.complex_output = _build_bank(
            self.n, widths, wavelet, w)
        self.nfft = _pick_nfft(self.n + self._lmax - 1)
        from .nd import fftn_split

        br = jnp.asarray(bank.real, jnp.float32)
        bi = jnp.asarray(bank.imag, jnp.float32)
        pad = [(0, 0), (0, self.nfft - bank.shape[-1])]
        self._Br, self._Bi = jax.jit(
            lambda a, b: fftn_split(jnp.pad(a, pad), jnp.pad(b, pad),
                                    (1,), FORWARD, None))(br, bi)
        self._jit = None

    def _build(self):
        from .nd import fftn_split

        n, nfft, lmax = self.n, self.nfft, self._lmax

        def impl(x, Br, Bi):
            xp = jnp.pad(x, (0, nfft - n))
            Xr, Xi = fftn_split(xp, jnp.zeros_like(xp), (0,), FORWARD,
                                None)
            Yr = Xr * Br - Xi * Bi
            Yi = Xr * Bi + Xi * Br
            yr, yi = fftn_split(Yr, Yi, (1,), INVERSE, 1.0 / nfft)
            start = (lmax - 1) // 2
            return (jax.lax.dynamic_slice_in_dim(yr, start, n, 1),
                    jax.lax.dynamic_slice_in_dim(yi, start, n, 1))

        return jax.jit(impl)

    def apply(self, x):
        x = jnp.asarray(x, jnp.float32)
        if x.ndim != 1 or int(x.shape[0]) != self.n:
            raise ValueError(f"CWT plan expects a 1-D signal of length "
                             f"{self.n}")
        if self._jit is None:
            self._jit = self._build()
        rr, ri = self._jit(x, self._Br, self._Bi)
        return merge(rr, ri) if self.complex_output else rr

    __call__ = apply


@partial(jax.jit, static_argnums=(3, 4, 5))
def _cwt_impl(x, br, bi, nfft, n, lmax):
    from .nd import fftn_split

    xp = jnp.pad(x, (0, nfft - n))
    Xr, Xi = fftn_split(xp, jnp.zeros_like(xp), (0,), FORWARD, None)
    bp = [(0, 0), (0, nfft - br.shape[-1])]
    Br, Bi = fftn_split(jnp.pad(br, bp), jnp.pad(bi, bp), (1,),
                        FORWARD, None)
    Yr = Xr * Br - Xi * Bi
    Yi = Xr * Bi + Xi * Br
    yr, yi = fftn_split(Yr, Yi, (1,), INVERSE, 1.0 / nfft)
    # full-convolution length n + lmax - 1; 'same' keeps n centered
    start = (lmax - 1) // 2
    return (jax.lax.dynamic_slice_in_dim(yr, start, n, 1),
            jax.lax.dynamic_slice_in_dim(yi, start, n, 1))
