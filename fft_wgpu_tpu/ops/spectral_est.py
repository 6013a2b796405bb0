"""Spectral estimation: periodogram / Welch / CSD / coherence / spectrogram.

scipy.signal-parity surface built on the framework's batched R2C/C2C
pipeline: segmentation is the scatter-free framing used by stft
(ops/stft.py), the hot loop is the batched R2C, and each entry point
traces into ONE jitted program (CLAUDE.md invariant — one dispatch, not
one per eager op).

The reference library has no signal-analysis layer at all (it is a bare
batched FFT, SURVEY §2); this module is part of the framework-completeness
superset, like ops/stft.py and ops/helpers.py.

Conventions (matching scipy.signal):
  * `scaling="density"`: Pxx in V**2/Hz, normalized by fs * sum(w**2).
  * `scaling="spectrum"`: Pxx in V**2, normalized by sum(w)**2.
  * one-sided spectra double every bin except DC (and Nyquist for even
    nfft); complex inputs always return the two-sided spectrum.
  * Welch's `average="median"` divides by the median bias correction
    (scipy.signal._spectral_py._median_bias).
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge, promote_to_split
from . import windows as _windows
from .helpers import fftfreq, rfftfreq
from .stft import (
    _frame,
    bartlett_window,
    blackman_window,
    hamming_window,
    hann_window,
)

__all__ = [
    "get_window",
    "check_COLA",
    "check_NOLA",
    "tukey_window",
    "kaiser_window",
    "flattop_window",
    "dpss",
    "periodogram",
    "welch",
    "csd",
    "coherence",
    "multitaper",
    "spectrogram",
    "lombscargle",
]


def tukey_window(n: int, alpha: float = 0.5, *, periodic: bool = False):
    """Tukey (tapered cosine) window, scipy.signal.windows.tukey parity."""
    if n == 1:
        return jnp.ones((1,), jnp.float32)
    if alpha <= 0:
        return jnp.ones((n,), jnp.float32)
    m = n + 1 if periodic else n
    if alpha >= 1.0:
        return hann_window(n, periodic=periodic)
    k = np.arange(m, dtype=np.float64)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    w = np.ones(m, np.float64)
    edge = k[: width + 1]
    w[: width + 1] = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * edge / alpha / (m - 1))))
    w[-(width + 1):] = w[: width + 1][::-1]
    return jnp.asarray(w[:n].astype(np.float32))


def kaiser_window(n: int, beta: float = 8.6, *, periodic: bool = False):
    """Kaiser window (scipy.signal.windows.kaiser parity; sym = not periodic)."""
    if n == 1:
        return jnp.ones((1,), jnp.float32)
    m = n + 1 if periodic else n
    k = np.arange(m, dtype=np.float64)
    alpha = (m - 1) / 2.0
    w = np.i0(beta * np.sqrt(1 - ((k - alpha) / alpha) ** 2)) / np.i0(beta)
    return jnp.asarray(w[:n].astype(np.float32))


def flattop_window(n: int, *, periodic: bool = False):
    """Flat-top window (scipy.signal.windows.flattop coefficients)."""
    if n == 1:
        return jnp.ones((1,), jnp.float32)
    m = n + 1 if periodic else n
    a = (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368)
    k = np.arange(m, dtype=np.float64)
    fac = 2 * np.pi * k / (m - 1)
    w = np.zeros(m, np.float64)
    for j, aj in enumerate(a):
        w += (-1) ** j * aj * np.cos(j * fac)
    return jnp.asarray(w[:n].astype(np.float32))


def dpss(M: int, NW: float, Kmax: int | None = None, sym: bool = True, *,
         norm=None, return_ratios: bool = False):
    """Discrete prolate spheroidal (Slepian) tapers.

    scipy.signal.windows.dpss parity (sym=True layout): the first ``Kmax``
    eigenvectors of the symmetric tridiagonal concentration operator
    (Percival & Walden eq. 378), computed in f64 on the host — windows are
    plan-time constants, like every trig table in this framework
    (CLAUDE.md).  Returns float32 windows ``[Kmax, M]`` (or ``[M]`` when
    ``Kmax is None``), optionally with the spectral concentration ratios
    ``lambda_k`` (f64, computed exactly via the sinc-kernel quadratic form
    evaluated with an FFT linear convolution).

    The reference library has no windowing layer (SURVEY §2); this backs
    `multitaper`.
    """
    if NW <= 0:
        raise ValueError("NW must be positive")
    squeeze = Kmax is None
    if Kmax is None:
        Kmax = 1
    Kmax = int(Kmax)
    if norm is None:
        norm = "approximate" if squeeze else 2
    if norm not in (2, "approximate", "subsample"):
        raise ValueError(f"norm must be 2, 'approximate' or 'subsample', "
                         f"got {norm!r}")
    trunc = 0
    if not sym:  # periodic window: compute at M+1, drop the last sample
        M, trunc = M + 1, 1
    if not 0 < Kmax <= M:
        raise ValueError("Kmax must be in (0, M]")
    if float(NW) >= M / 2.0:
        raise ValueError("NW must be < M/2")
    W = float(NW) / M
    from scipy.linalg import eigh_tridiagonal

    t = np.arange(M, dtype=np.float64)
    d = ((M - 1 - 2 * t) / 2.0) ** 2 * np.cos(2 * np.pi * W)
    e = t[1:] * (M - t[1:]) / 2.0
    _, wins = eigh_tridiagonal(d, e, select="i",
                               select_range=(M - Kmax, M - 1))
    wins = wins[:, ::-1].T  # [Kmax, M], descending concentration
    # scipy sign convention (Percival & Walden pg 379): symmetric tapers
    # have positive mean; antisymmetric tapers begin with a positive lobe
    # (first sample above numerical noise must be positive).
    fix_even = wins[::2].sum(axis=1) < 0
    wins[::2][fix_even] *= -1
    thresh = max(1e-7, 1.0 / M)
    for i, w in enumerate(wins[1::2]):
        if w[w * w > thresh][0] < 0:
            wins[2 * i + 1] *= -1
    # concentration ratios: lam_k = w^T R w with R[i,j] = sin(2 pi W (i-j))
    # / (pi (i-j)), diag 2W — evaluated as an FFT linear convolution.
    lam = None
    if return_ratios:
        dlt = np.arange(-(M - 1), M, dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            r = np.sin(2 * np.pi * W * dlt) / (np.pi * dlt)
        r[M - 1] = 2 * W
        L = int(2 ** np.ceil(np.log2(2 * M - 1)))
        Rf = np.fft.rfft(r, L)
        conv = np.fft.irfft(np.fft.rfft(wins, L, axis=1) * Rf, L, axis=1)
        Rw = conv[:, M - 1:2 * M - 1]
        lam = np.einsum("km,km->k", wins, Rw)
    if norm != 2:
        # scipy's unit-peak normalization: divide by the global max, then
        # correct even-M peak placement ('approximate': closed form;
        # 'subsample': exact half-sample shift via the FFT of window 0)
        wins /= wins.max()
        if M % 2 == 0:
            if norm == "approximate":
                correction = M * M / float(M * M + NW)
            else:
                s = np.fft.rfft(wins[0])
                shift = -(1 - 1.0 / M) * np.arange(1, M // 2 + 1)
                s[1:] *= 2 * np.exp(-1j * np.pi * shift)
                correction = M / s.real.sum()
            wins *= correction
    if trunc:
        wins = wins[:, :-trunc]
    out = jnp.asarray(wins.astype(np.float32))
    if squeeze:
        out = out[0]
        if lam is not None:
            lam = lam[0]
    if return_ratios:
        return out, lam
    return out


_WINDOWS = {
    "hann": hann_window,
    "hanning": hann_window,
    "hamming": hamming_window,
    "blackman": blackman_window,
    "bartlett": bartlett_window,
    "flattop": flattop_window,
    "triang": _windows.triang_window,
    "triangle": _windows.triang_window,
    "parzen": _windows.parzen_window,
    "bohman": _windows.bohman_window,
    "nuttall": _windows.nuttall_window,
    "blackmanharris": _windows.blackmanharris_window,
    "cosine": _windows.cosine_window,
    "halfcosine": _windows.cosine_window,
    "barthann": _windows.barthann_window,
    "lanczos": _windows.lanczos_window,
    "sinc": _windows.lanczos_window,
    "exponential": _windows.exponential_window,
    "poisson": _windows.exponential_window,
    # parameterized windows whose defaults scipy also accepts bare
    "tukey": tukey_window,
    "taylor": _windows.taylor_window,
}

# Parameterized windows usable via the (name, *params) tuple form.
_PARAM_WINDOWS = {
    "tukey": tukey_window,
    "kaiser": kaiser_window,
    "gaussian": _windows.gaussian_window,
    "gauss": _windows.gaussian_window,
    "general_gaussian": _windows.general_gaussian_window,
    "general_cosine": _windows.general_cosine_window,
    "general_hamming": _windows.general_hamming_window,
    "chebwin": _windows.chebwin_window,
    "cheb": _windows.chebwin_window,
    "taylor": _windows.taylor_window,
    "exponential": _windows.exponential_window,
    "poisson": _windows.exponential_window,
    "kaiser_bessel_derived": _windows.kaiser_bessel_derived_window,
}


def get_window(window, nperseg: int, fftbins=None, *,
               periodic: bool = True):
    """Resolve a window spec (name, (name, param), or array) to a float32
    array of length nperseg (scipy.signal.get_window-style; scipy's
    fftbins= is accepted positionally/by keyword and aliases
    periodic=)."""
    if fftbins is not None:
        periodic = bool(fftbins)
    if isinstance(window, str):
        if window in ("boxcar", "rectangular", "ones"):
            return jnp.ones((nperseg,), jnp.float32)
        fn = _WINDOWS.get(window)
        if fn is not None:
            return fn(nperseg, periodic=periodic)
        if window in _PARAM_WINDOWS:
            raise ValueError(f"window {window!r} requires parameters: pass "
                             f"a tuple like ({window!r}, param)")
        raise ValueError(f"unknown window {window!r}")
    if isinstance(window, tuple):
        name, *params = window
        if name == "dpss":
            return dpss(nperseg, *params)
        fn = _PARAM_WINDOWS.get(name)
        if fn is None:
            raise ValueError(f"unknown window {window!r}")
        return fn(nperseg, *params, periodic=periodic)
    w = jnp.asarray(window, jnp.float32)
    if w.ndim != 1:
        raise ValueError("window must be 1-D")
    if w.shape[0] != nperseg:
        raise ValueError(f"window length {w.shape[0]} != nperseg {nperseg}")
    return w


def _detrend_seg(fr, detrend):
    """Per-segment detrend over the last axis ('constant'|'linear'|False)."""
    if detrend is False or detrend is None:
        return fr
    if detrend == "constant":
        return fr - jnp.mean(fr, axis=-1, keepdims=True)
    if detrend == "linear":
        n = fr.shape[-1]
        t = jnp.arange(n, dtype=jnp.float32)
        tbar = (n - 1) / 2.0
        tc = t - tbar
        denom = jnp.sum(tc * tc)
        ybar = jnp.mean(fr, axis=-1, keepdims=True)
        slope = jnp.sum(fr * tc, axis=-1, keepdims=True) / denom
        return fr - ybar - slope * tc
    raise ValueError(f"invalid detrend {detrend!r}")


def _median_bias(n: int) -> float:
    """Bias of the median of n periodogram samples (scipy parity)."""
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


def _spec_segments_split(xr, xi, win, nperseg, hop, nfft, detrend):
    """Frame, detrend, window, transform: returns split [.., num, bins]
    (full two-sided bins for complex input, half spectrum for real)."""
    from .nd import fftn_split
    from ..core.twiddle import FORWARD
    from .rfft import rfft_last_split

    frames_r = _detrend_seg(_frame(xr, nperseg, hop), detrend) * win
    if xi is None:
        if nfft > nperseg:
            pad = [(0, 0)] * (frames_r.ndim - 1) + [(0, nfft - nperseg)]
            frames_r = jnp.pad(frames_r, pad)
        return rfft_last_split(frames_r, None)
    frames_i = _detrend_seg(_frame(xi, nperseg, hop), detrend) * win
    if nfft > nperseg:
        pad = [(0, 0)] * (frames_r.ndim - 1) + [(0, nfft - nperseg)]
        frames_r = jnp.pad(frames_r, pad)
        frames_i = jnp.pad(frames_i, pad)
    return fftn_split(frames_r, frames_i, (frames_r.ndim - 1,), FORWARD, None)


def _is_complex(x) -> bool:
    """True for complex arrays and explicit (re, im) split pairs;
    promote_to_split returns a ZERO imag for real input, so complexness
    must be decided before promotion."""
    if isinstance(x, (tuple, list)) and len(x) == 2:
        return True
    if isinstance(x, np.ndarray):
        return bool(np.iscomplexobj(x))
    return bool(jnp.iscomplexobj(jnp.asarray(x) if not hasattr(x, "dtype") else x))


def _resolve_args(x, y, nperseg, noverlap, nfft, window, axis):
    xr, xi = promote_to_split(x)
    if not _is_complex(x):
        xi = None
    if y is not None:
        yr, yi = promote_to_split(y)
        if not _is_complex(y):
            yi = None
        # scipy broadcasts x and y; support the common equal-shape case
        if yr.shape[axis] != xr.shape[axis]:
            raise ValueError("x and y must have the same length along axis")
    else:
        yr = yi = None
    n = xr.shape[axis]
    if nperseg is None:
        nperseg = min(256, n)
    if nperseg > n:
        warnings.warn(
            f"nperseg = {nperseg} is greater than signal length = {n}, "
            f"using nperseg = {n}"
        )
        nperseg = n
    if nfft is None:
        nfft = nperseg
    elif nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    if noverlap is None:
        noverlap = nperseg // 2
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    win = get_window(window, nperseg)
    complex_input = xi is not None or (y is not None and yi is not None)
    return xr, xi, yr, yi, nperseg, int(noverlap), nfft, win, complex_input


# --------------------------------------------------------------------- #
# Config-keyed jit cache (round 5): each estimator call used to build a
# fresh closure and jax.jit it, re-tracing on EVERY call (~0.4-0.6 s of
# host time even with the persistent compile cache).  Hashable configs
# reuse the traced executable like the plan layer does; array/callable
# windows (or any unhashable key part) skip the cache safely.
from ..utils.jit_cache import cached_call as _cached_call
from ..utils.jit_cache import shape_key as _shape_key
from ..utils.jit_cache import window_key as _window_key


def _csd_impl(x, y, fs, window, nperseg, noverlap, nfft, detrend,
              return_onesided, scaling, axis, average):
    (xr, xi, yr, yi, nperseg, noverlap, nfft, win,
     complex_input) = _resolve_args(x, y, nperseg, noverlap, nfft, window,
                                    axis)
    onesided = return_onesided and not complex_input
    hop = nperseg - noverlap

    if scaling == "density":
        norm = 1.0 / (fs * float(jnp.sum(win * win)))
    elif scaling == "spectrum":
        norm = 1.0 / float(jnp.sum(win)) ** 2
    else:
        raise ValueError(f"invalid scaling {scaling!r}")

    same = y is None

    def impl(xr, xi, yr, yi):
        def mv(a):
            return jnp.moveaxis(a, axis, -1) if a is not None else None

        xr_, xi_, yr_, yi_ = mv(xr), mv(xi), mv(yr), mv(yi)
        # two-sided output needs the full C2C path even for real input
        if not onesided and xi_ is None:
            xi_ = jnp.zeros_like(xr_)
        if not onesided and yr_ is not None and yi_ is None:
            yi_ = jnp.zeros_like(yr_)

        Xr, Xi = _spec_segments_split(xr_, xi_, win, nperseg, hop, nfft,
                                      detrend)
        if same:
            Pr = Xr * Xr + Xi * Xi          # X * conj(X)
            Pi = jnp.zeros_like(Pr)
        else:
            Yr, Yi = _spec_segments_split(yr_, yi_, win, nperseg, hop, nfft,
                                          detrend)
            # scipy: Pxy = conj(X) * Y
            Pr = Xr * Yr + Xi * Yi
            Pi = Xr * Yi - Xi * Yr
        num = Pr.shape[-2]
        if average == "mean":
            Pr = jnp.mean(Pr, axis=-2)
            Pi = jnp.mean(Pi, axis=-2)
        elif average == "median":
            bias = _median_bias(num)
            Pr = jnp.median(Pr, axis=-2) / bias
            Pi = jnp.median(Pi, axis=-2) / bias
        else:
            raise ValueError(f"invalid average {average!r}")
        Pr = Pr * norm
        Pi = Pi * norm
        if onesided:
            mult = np.full(nfft // 2 + 1, 2.0, np.float32)
            mult[0] = 1.0
            if nfft % 2 == 0:
                mult[-1] = 1.0
            Pr = Pr * mult
            Pi = Pi * mult
        return jnp.moveaxis(Pr, -1, axis), jnp.moveaxis(Pi, -1, axis)

    wkey = _window_key(window)
    key = None if wkey is None else (
        "csd", jax.default_backend(), _shape_key(xr), _shape_key(xi),
        _shape_key(yr), _shape_key(yi), float(fs), wkey, nperseg,
        noverlap, nfft, detrend, return_onesided, scaling, axis, average)
    Pr, Pi = _cached_call(key, impl, xr, xi, yr, yi)
    if onesided:
        f = rfftfreq(nfft, 1.0 / fs)
    else:
        f = fftfreq(nfft, 1.0 / fs)
    return f, Pr, Pi, onesided


def periodogram(x, fs: float = 1.0, window="boxcar", nfft: int | None = None,
                detrend="constant", return_onesided: bool = True,
                scaling: str = "density", axis: int = -1):
    """Power spectral density with a single segment (scipy.signal parity).

    Returns (f, Pxx); Pxx is real float32.
    """
    xr, _ = promote_to_split(x)
    n = xr.shape[axis]
    f, Pr, _Pi, _onesided = _csd_impl(
        x, None, fs, window, n, 0, nfft, detrend, return_onesided, scaling,
        axis, "mean")
    return f, Pr


def welch(x, fs: float = 1.0, window="hann", nperseg: int | None = None,
          noverlap: int | None = None, nfft: int | None = None,
          detrend="constant", return_onesided: bool = True,
          scaling: str = "density", axis: int = -1, average: str = "mean"):
    """Welch averaged-periodogram PSD (scipy.signal.welch parity).

    Returns (f, Pxx); Pxx is real float32.
    """
    f, Pr, _Pi, _onesided = _csd_impl(
        x, None, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, average)
    return f, Pr


def csd(x, y, fs: float = 1.0, window="hann", nperseg: int | None = None,
        noverlap: int | None = None, nfft: int | None = None,
        detrend="constant", return_onesided: bool = True,
        scaling: str = "density", axis: int = -1, average: str = "mean"):
    """Cross power spectral density Pxy = E[conj(X) Y] (scipy parity).

    Returns (f, Pxy) with complex64 Pxy.
    """
    f, Pr, Pi, _onesided = _csd_impl(
        x, y, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, average)
    return f, merge(Pr, Pi)


def coherence(x, y, fs: float = 1.0, window="hann",
              nperseg: int | None = None, noverlap: int | None = None,
              nfft: int | None = None, detrend="constant", axis: int = -1):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy) (scipy parity)."""
    f, Pxyr, Pxyi, _ = _csd_impl(x, y, fs, window, nperseg, noverlap, nfft,
                                 detrend, True, "density", axis, "mean")
    _, Pxx, _, _ = _csd_impl(x, None, fs, window, nperseg, noverlap, nfft,
                             detrend, True, "density", axis, "mean")
    _, Pyy, _, _ = _csd_impl(y, None, fs, window, nperseg, noverlap, nfft,
                             detrend, True, "density", axis, "mean")
    return f, jax.jit(
        lambda pr, pi, a, b: (pr * pr + pi * pi) / (a * b)
    )(Pxyr, Pxyi, Pxx, Pyy)


def multitaper(x, fs: float = 1.0, NW: float = 4.0, K: int | None = None,
               nfft: int | None = None, detrend="constant",
               return_onesided: bool = True, axis: int = -1,
               weights: str = "adaptive", n_iter: int = 10):
    """Thomson multitaper PSD estimate with DPSS tapers.

    Not in scipy.signal (scipy has no multitaper); conventions follow
    Percival & Walden.  ``K`` defaults to ``floor(2 NW) - 1`` tapers.
    ``weights``: 'unity' (plain mean of eigenspectra), 'eigen'
    (concentration-weighted mean), or 'adaptive' (Thomson's iterative
    data-dependent weights, ``n_iter`` fixed-point steps inside the jitted
    program — no data-dependent Python control flow, CLAUDE.md).

    One jitted program per (shape, K, nfft): the K tapered transforms run
    as ONE batched R2C/C2C call.
    Returns (f, Pxx) with density scaling (V**2/Hz); Pxx is real float32.
    """
    xr, xi = promote_to_split(x)
    if not _is_complex(x):
        xi = None
    n = xr.shape[axis]
    if K is None:
        K = max(int(2 * NW) - 1, 1)
    if nfft is None:
        nfft = n
    elif nfft < n:
        raise ValueError("nfft must be >= signal length")
    tapers, lam = dpss(n, NW, K, return_ratios=True)
    onesided = return_onesided and xi is None
    if weights not in ("unity", "eigen", "adaptive"):
        raise ValueError(f"invalid weights {weights!r}")
    lam32 = jnp.asarray(np.asarray(lam, np.float64).astype(np.float32))

    def impl(xr_, xi_):
        from ..core.twiddle import FORWARD
        from .nd import fftn_split
        from .rfft import rfft_last_split

        v_r = jnp.moveaxis(xr_, axis, -1)
        v_r = _detrend_seg(v_r, detrend)
        # two-sided output needs the full C2C path even for real input
        if not onesided and xi_ is None:
            xi_ = jnp.zeros_like(xr_)
        # [..., K, n]: taper axis broadcast against the signal
        t_r = v_r[..., None, :] * tapers
        if xi_ is None:
            if nfft > n:
                pad = [(0, 0)] * (t_r.ndim - 1) + [(0, nfft - n)]
                t_r = jnp.pad(t_r, pad)
            if nfft % 2 == 0:
                Xr, Xi = rfft_last_split(t_r, None)
            else:
                Xr, Xi = fftn_split(t_r, jnp.zeros_like(t_r),
                                    (t_r.ndim - 1,), FORWARD, None)
                Xr = Xr[..., : nfft // 2 + 1]
                Xi = Xi[..., : nfft // 2 + 1]
        else:
            v_i = _detrend_seg(jnp.moveaxis(xi_, axis, -1), detrend)
            t_i = v_i[..., None, :] * tapers
            if nfft > n:
                pad = [(0, 0)] * (t_r.ndim - 1) + [(0, nfft - n)]
                t_r = jnp.pad(t_r, pad)
                t_i = jnp.pad(t_i, pad)
            Xr, Xi = fftn_split(t_r, t_i, (t_r.ndim - 1,), FORWARD, None)
        Sk = (Xr * Xr + Xi * Xi) / fs  # [..., K, bins] eigenspectra
        if weights == "unity":
            S = jnp.mean(Sk, axis=-2)
        elif weights == "eigen":
            S = jnp.sum(Sk * lam32[:, None], axis=-2) / jnp.sum(lam32)
        else:
            # Thomson adaptive weights: b_k = S / (lam_k S + (1-lam_k) s2)
            s2 = jnp.mean(v_r * v_r, axis=-1, keepdims=True)[..., None]
            if xi_ is not None:
                s2 = s2 + jnp.mean(v_i * v_i, axis=-1, keepdims=True)[..., None]
            lamc = lam32[:, None]
            S0 = jnp.mean(Sk[..., :2, :], axis=-2)

            def body(_, S):
                b = S[..., None, :] / (lamc * S[..., None, :]
                                       + (1 - lamc) * s2 + 1e-30)
                w = b * b * lamc
                return jnp.sum(w * Sk, axis=-2) / (jnp.sum(w, axis=-2)
                                                   + 1e-30)

            S = jax.lax.fori_loop(0, n_iter, body, S0)
        if onesided:
            mult = np.full(nfft // 2 + 1, 2.0, np.float32)
            mult[0] = 1.0
            if nfft % 2 == 0:
                mult[-1] = 1.0
            S = S * mult
        return jnp.moveaxis(S, -1, axis)

    key = ("mt", jax.default_backend(), _shape_key(xr), _shape_key(xi),
           float(fs), float(NW), K, nfft, detrend, onesided, weights,
           axis)
    S = _cached_call(key, impl, xr, xi)
    f = rfftfreq(nfft, 1.0 / fs) if onesided else fftfreq(nfft, 1.0 / fs)
    return f, S


def spectrogram(x, fs: float = 1.0, window=("tukey", 0.25),
                nperseg: int | None = None, noverlap: int | None = None,
                nfft: int | None = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                axis: int = -1, mode: str = "psd"):
    """Spectrogram over sliding segments (scipy.signal.spectrogram parity).

    Returns (f, t, Sxx) with segment times t and Sxx [..., bins, num]
    (frequency axis where `axis` was, time last — scipy layout).
    mode: 'psd' (default), 'magnitude', or 'complex'.
    """
    (xr, xi, _yr, _yi, nperseg, noverlap_d, nfft, win,
     complex_input) = _resolve_args(x, None, nperseg, noverlap, nfft,
                                    window, axis)
    # scipy's spectrogram default overlap is nperseg // 8, not // 2
    if noverlap is None:
        noverlap_d = nperseg // 8
    hop = nperseg - noverlap_d
    onesided = return_onesided and not complex_input

    if scaling == "density":
        norm = 1.0 / (fs * float(jnp.sum(win * win)))
    elif scaling == "spectrum":
        norm = 1.0 / float(jnp.sum(win)) ** 2
    else:
        raise ValueError(f"invalid scaling {scaling!r}")

    def impl(xr_, xi_):
        v_r = jnp.moveaxis(xr_, axis, -1)
        v_i = jnp.moveaxis(xi_, axis, -1) if xi_ is not None else None
        if not onesided and v_i is None:
            v_i = jnp.zeros_like(v_r)  # two-sided needs the full C2C path
        Xr, Xi = _spec_segments_split(v_r, v_i, win, nperseg, hop, nfft,
                                      detrend)
        if mode == "psd":
            S = (Xr * Xr + Xi * Xi) * norm
            if onesided:
                mult = np.full(S.shape[-1], 2.0, np.float32)
                mult[0] = 1.0
                if nfft % 2 == 0:
                    mult[-1] = 1.0
                S = S * mult
            return (jnp.swapaxes(S, -1, -2),)
        if mode == "magnitude":
            S = jnp.sqrt(Xr * Xr + Xi * Xi) * float(np.sqrt(norm))
            return (jnp.swapaxes(S, -1, -2),)
        if mode == "complex":
            s = float(np.sqrt(norm))
            return (jnp.swapaxes(Xr, -1, -2) * s,
                    jnp.swapaxes(Xi, -1, -2) * s)
        if mode in ("angle", "phase"):
            ang = jnp.swapaxes(jnp.arctan2(Xi, Xr), -1, -2)
            if mode == "phase":  # scipy: unwrapped along the time axis
                ang = jnp.unwrap(ang, axis=-1)
            return (ang,)
        raise ValueError(f"invalid mode {mode!r}")

    wkey = _window_key(window)
    key = None if wkey is None else (
        "spec", jax.default_backend(), _shape_key(xr), _shape_key(xi),
        float(fs), wkey, nperseg, hop, nfft, detrend, return_onesided,
        scaling, axis, mode)
    out = _cached_call(key, impl, xr, xi)
    n = xr.shape[axis]
    num = 1 + (n - nperseg) // hop
    t = (np.arange(num) * hop + nperseg / 2.0) / fs
    f = rfftfreq(nfft, 1.0 / fs) if onesided else fftfreq(nfft, 1.0 / fs)
    if mode == "complex":
        return f, t, merge(out[0], out[1])
    return f, t, out[0]


@functools.partial(jax.jit, static_argnames=("floating_mean",))
def _lombscargle_core(x, y, w, freqs, floating_mean: bool = False):
    """Zechmeister-Kuerster generalized Lomb-Scargle inner math (scipy
    1.17 lombscargle): returns (a, b, tau, YY) per frequency.  All
    contractions are [N] x [N, K] matvecs, at HIGHEST precision (a GPU's
    DEFAULT would run them as TF32, ~1e-3 relative)."""
    mv = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    wy = w * y
    ft = freqs[None, :] * x[:, None]          # [N, K]
    cos1, sin1 = jnp.cos(ft), jnp.sin(ft)
    Y = mv(w, y)
    CC = mv(w, cos1 * cos1)
    SS = 1.0 - CC
    CS = mv(w, cos1 * sin1)
    if floating_mean:
        C = mv(w, cos1)
        S = mv(w, sin1)
        CC = CC - C * C
        SS = SS - S * S
        CS = CS - C * S
    tau = 0.5 * jnp.arctan2(2.0 * CS, CC - SS)
    ctau, stau = jnp.cos(tau), jnp.sin(tau)
    # cos(ft - tau), sin(ft - tau) without recomputing trig of ft
    cosr = cos1 * ctau + sin1 * stau
    sinr = sin1 * ctau - cos1 * stau
    YC = mv(wy, cosr)
    YS = mv(wy, sinr)
    CC = mv(w, cosr * cosr)
    SS = 1.0 - CC
    if floating_mean:
        C = mv(w, cosr)
        S = mv(w, sinr)
        YC = YC - Y * C
        YS = YS - Y * S
        CC = CC - C * C
        SS = SS - S * S
    eps = jnp.float32(np.finfo(np.float32).epsneg)
    CC = jnp.maximum(CC, eps)
    SS = jnp.maximum(SS, eps)
    a = YC / CC
    b = YS / SS
    YY = mv(wy, y)
    if floating_mean:
        YY = YY - Y * Y
    return a, b, tau, YC, YS, YY


def lombscargle(x, y, freqs, *, precenter=False, normalize=False,
                weights=None, floating_mean: bool = False):
    """Generalized (weighted, floating-mean) Lomb-Scargle periodogram of
    unevenly sampled data (scipy.signal.lombscargle >= 1.17 parity).

    normalize: False/'power' (legacy A^2 N/4 units), True/'normalize'
    ([0, 1] fraction of total variance), or 'amplitude' (complex
    best-fit a + ib, tau-corrected).  `precenter` subtracts the plain
    mean of y first (scipy's deprecated legacy knob; prefer
    floating_mean).  One jitted program; the per-frequency least
    squares runs as [N] x [N, K] contractions.
    The uneven-sampling counterpart of `periodogram`; for transforming
    (rather than fitting) nonuniform samples see ops/nufft.py.
    """
    if precenter:
        import warnings

        warnings.warn("the 'precenter' keyword is deprecated (scipy "
                      "1.17); use floating_mean instead",
                      DeprecationWarning, stacklevel=2)
        y0 = np.asarray(y) if isinstance(y, np.ndarray) else y
        y = y0 - y0.mean()
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    freqs = jnp.asarray(freqs, jnp.float32)
    if x.ndim != 1 or x.shape != y.shape or x.size == 0:
        raise ValueError("x and y must be equal-length non-empty 1-D arrays")
    if freqs.ndim != 1 or freqs.size == 0:
        raise ValueError("freqs must be a non-empty 1-D array")
    if weights is None:
        w = np.full(x.shape[0], 1.0 / x.shape[0], np.float32)
    else:
        w = np.asarray(weights, np.float64)
        if w.shape != tuple(x.shape) or (w < 0).any() or w.sum() <= 0:
            raise ValueError("weights must be non-negative, match x, and "
                             "sum to a positive value")
        w = (w / w.sum()).astype(np.float32)
    if isinstance(normalize, bool):
        normalize = "normalize" if normalize else "power"
    if normalize not in ("power", "normalize", "amplitude"):
        raise ValueError("normalize must be False/'power', "
                         "True/'normalize', or 'amplitude'")
    a, b, tau, YC, YS, YY = _lombscargle_core(
        x, y, jnp.asarray(w), freqs, floating_mean=bool(floating_mean))
    pgram = 2.0 * (a * YC + b * YS)
    if normalize == "power":
        return pgram * (x.shape[0] / 4.0)
    if normalize == "normalize":
        return pgram * (0.5 / YY)
    from ..core.complex_utils import merge

    # amplitude: (a + ib) e^{i tau}
    ct, st = jnp.cos(tau), jnp.sin(tau)
    return merge(a * ct - b * st, a * st + b * ct)


def _ola_binsums(window, nperseg: int, noverlap: int, power: float):
    """Overlap-added window (or window-power) sums over one hop period."""
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if not 0 <= noverlap < nperseg:
        raise ValueError("noverlap must satisfy 0 <= noverlap < nperseg")
    win = np.asarray(get_window(window, nperseg, periodic=True), np.float64)
    w = win ** power
    step = nperseg - noverlap
    binsums = sum(w[ii * step:(ii + 1) * step]
                  for ii in range(nperseg // step))
    if nperseg % step != 0:
        binsums[: nperseg % step] += w[-(nperseg % step):]
    return binsums


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """True if (window, hop) satisfies the Constant-OverLap-Add constraint
    (scipy.signal.check_COLA parity) — the condition under which istft with
    no window correction reconstructs exactly.

    Framework windows are float32 tables (CLAUDE.md: f64-generated, cast
    once), so the deviation of a mathematically-COLA pair is ~1e-8, not 0;
    the effective tolerance therefore floors at a few f32 ulps of the
    overlap-add level.  Genuinely non-COLA pairs deviate at O(1)."""
    binsums = _ola_binsums(window, nperseg, noverlap, 1.0)
    tol = max(float(tol),
              32 * float(np.finfo(np.float32).eps) * float(np.max(binsums)))
    return bool(np.max(np.abs(binsums - np.median(binsums))) < tol)


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """True if (window, hop) satisfies the NOnzero-OverLap-Add constraint
    (scipy.signal.check_NOLA parity: min of the overlap-added squared
    window > tol) — the weaker condition required for least-squares istft
    inversion (ops/short_time_fft.py istft)."""
    binsums = _ola_binsums(window, nperseg, noverlap, 2.0)
    return bool(np.min(binsums) > tol)
