"""Multirate signal processing: window-method FIR design + polyphase-style
resampling on the FFT path (scipy.signal firwin/upfirdn/resample_poly
parity).

Framework completeness layer: the reference library is a bare batched FFT
(SURVEY §2 — no filtering at all); these round out the signal toolkit next
to ops/helpers.resample (Fourier-domain resampling) with the rational-rate
method every scipy user expects.

Design notes:
- Filter *design* (firwin) is tiny host math: generated in float64 numpy
  like every trig/window table (CLAUDE.md invariant), cast once where it
  enters a device program.
- upfirdn runs as ONE jitted program per (shape, up, down, n_h) geometry:
  zero-stuff -> pow2-padded R2C convolution -> stride-slice.  scipy
  implements this as a polyphase C loop; the FFT form is a few batched
  device passes and avoids per-phase gathers.
- Signal-extension modes are realized by explicit jnp.pad pre-extension
  with a mode-aligned offset (the virtual-extension C trick doesn't map
  to static shapes), so outputs match scipy bit-for-bit in geometry.
- Complex inputs are split (re, im) at the host boundary (no complex
  host<->device transfer — CLAUDE.md).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .helpers import _as_host_or_device, _iscomplex

__all__ = [
    "kaiser_atten",
    "kaiser_beta",
    "kaiserord",
    "firwin",
    "firwin2",
    "firls",
    "remez",
    "upfirdn",
    "resample_poly",
    "decimate",
    "freqz",
    "group_delay",
]


# ---------------------------------------------------------------------------
# FIR design (host-side, float64)
# ---------------------------------------------------------------------------

def _design_window64(window, numtaps: int) -> np.ndarray:
    """Symmetric window for FIR design, float64 on the host.

    The framework window zoo returns device float32 tables (fine for
    spectral analysis); filter DESIGN wants f64 taps and must not issue
    device dispatches, so the standard design windows are generated here
    directly.  Exotic windows fall back to the zoo at f32 accuracy."""
    if numtaps == 1:
        return np.ones(1, np.float64)
    name = window if isinstance(window, str) else (
        window[0] if isinstance(window, tuple) else None)
    params = window[1:] if isinstance(window, tuple) else ()
    n = np.arange(numtaps, dtype=np.float64)
    m = numtaps - 1.0
    if name in ("boxcar", "rectangular", "ones"):
        return np.ones(numtaps, np.float64)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * n / m)
    if name in ("hann", "hanning"):
        return 0.5 - 0.5 * np.cos(2 * np.pi * n / m)
    if name == "blackman":
        return (0.42 - 0.5 * np.cos(2 * np.pi * n / m)
                + 0.08 * np.cos(4 * np.pi * n / m))
    if name == "bartlett":
        return np.bartlett(numtaps)
    if name == "kaiser" and params:
        return np.kaiser(numtaps, float(params[0]))
    from .spectral_est import get_window

    return np.asarray(get_window(window, numtaps, periodic=False),
                      np.float64)


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a Kaiser FIR filter given its transition width
    (scipy.signal.kaiser_atten)."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def kaiser_beta(a: float) -> float:
    """Kaiser-window beta for a given stopband attenuation `a` in dB
    (scipy.signal.kaiser_beta)."""
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def firwin(numtaps: int, cutoff, *, width=None, window="hamming",
           pass_zero=True, scale=True, fs: float = 2.0) -> np.ndarray:
    """Window-method FIR filter design (scipy.signal.firwin parity).

    Returns the tap array as float64 numpy (host table — it parameterizes
    device programs, it is not itself device compute).  `pass_zero` takes
    scipy's bool or string forms ('lowpass'/'highpass'/'bandpass'/
    'bandstop').
    """
    if numtaps < 1:
        raise ValueError("numtaps must be >= 1")
    nyq = 0.5 * fs
    cutoff = np.atleast_1d(np.asarray(cutoff, np.float64)) / nyq
    if cutoff.ndim > 1:
        raise ValueError("cutoff must be 1-D")
    if cutoff.size == 0:
        raise ValueError("at least one cutoff frequency required")
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise ValueError("cutoff must lie strictly between 0 and fs/2")
    if cutoff.size > 1 and np.any(np.diff(cutoff) <= 0):
        raise ValueError("cutoff frequencies must be strictly increasing")

    if isinstance(pass_zero, str):
        if pass_zero in ("bandstop", "lowpass"):
            if pass_zero == "lowpass" and cutoff.size != 1:
                raise ValueError("lowpass takes exactly one cutoff")
            if pass_zero == "bandstop" and cutoff.size < 2:
                raise ValueError("bandstop needs at least two cutoffs")
            pass_zero = True
        elif pass_zero in ("bandpass", "highpass"):
            if pass_zero == "highpass" and cutoff.size != 1:
                raise ValueError("highpass takes exactly one cutoff")
            if pass_zero == "bandpass" and cutoff.size < 2:
                raise ValueError("bandpass needs at least two cutoffs")
            pass_zero = False
        else:
            raise ValueError(f"invalid pass_zero {pass_zero!r}")
    pass_nyquist = bool(cutoff.size & 1) ^ bool(pass_zero)
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError("even numtaps has a zero at the Nyquist rate; "
                         "a filter passing Nyquist needs odd numtaps")

    if width is not None:
        beta = kaiser_beta(kaiser_atten(numtaps, float(width) / nyq))
        window = ("kaiser", beta)

    edges = np.concatenate((
        [0.0] if pass_zero else [],
        cutoff,
        [1.0] if pass_nyquist else [],
    ))
    bands = edges.reshape(-1, 2)

    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps, dtype=np.float64) - alpha
    h = np.zeros(numtaps, np.float64)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    # symmetric (sym=True == scipy fftbins=False) window, f64 on the host
    h *= _design_window64(window, numtaps)
    if scale:
        left, right = bands[0]
        if left == 0.0:
            scale_frequency = 0.0
        elif right == 1.0:
            scale_frequency = 1.0
        else:
            scale_frequency = 0.5 * (left + right)
        c = np.cos(np.pi * m * scale_frequency)
        h /= np.sum(h * c)
    return h


def firwin2(numtaps: int, freq, gain, *, nfreqs: int | None = None,
            window="hamming", antisymmetric: bool = False,
            fs: float = 2.0) -> np.ndarray:
    """Frequency-sampling FIR design (scipy.signal.firwin2 parity):
    interpolate the desired response on a fine grid, phase-shift so the
    impulse response is causal-centered, inverse-real-FFT, window.

    Host-side float64 design math like :func:`firwin` (the inverse FFT is
    a tiny 1-D table transform, not device compute).
    """
    nyq = 0.5 * fs
    freq = np.asarray(freq, np.float64)
    gain = np.asarray(gain, np.float64)
    if freq.shape != gain.shape or freq.ndim != 1:
        raise ValueError("freq and gain must be 1-D of the same length")
    if nfreqs is not None and numtaps >= nfreqs:
        raise ValueError("numtaps must be less than nfreqs")
    if freq[0] != 0 or freq[-1] != nyq:
        raise ValueError("freq must start with 0 and end with fs/2")
    d = np.diff(freq)
    if np.any(d < 0):
        raise ValueError("freq must be nondecreasing")
    if np.any(d[:-1] + d[1:] == 0):
        raise ValueError("a value in freq must not occur more than twice")
    if freq.size > 1 and (freq[1] == 0 or freq[-2] == nyq):
        raise ValueError("0 and fs/2 must not be repeated in freq")

    if antisymmetric:
        ftype = 4 if numtaps % 2 == 0 else 3
    else:
        ftype = 2 if numtaps % 2 == 0 else 1
    if ftype == 2 and gain[-1] != 0.0:
        raise ValueError("a Type II filter must have zero gain at Nyquist")
    if ftype == 3 and (gain[0] != 0.0 or gain[-1] != 0.0):
        raise ValueError("a Type III filter must have zero gain at zero "
                         "and Nyquist frequencies")
    if ftype == 4 and gain[0] != 0.0:
        raise ValueError("a Type IV filter must have zero gain at zero "
                         "frequency")

    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(numtaps)))

    if np.any(d == 0):  # nudge repeated freqs apart so interp is well-posed
        freq = freq.copy()
        eps = np.finfo(np.float64).eps * nyq
        for k in range(freq.size - 1):
            if freq[k] == freq[k + 1]:
                freq[k] -= eps
                freq[k + 1] += eps
        if np.any(np.diff(freq) <= 0):
            raise ValueError("freq values too close to a repeated value")

    x = np.linspace(0.0, nyq, nfreqs)
    fx = np.interp(x, freq, gain)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * x / nyq)
    if ftype > 2:
        shift = shift * 1j
    out_full = np.fft.irfft(fx * shift)
    if window is not None:
        wind = _design_window64(window, numtaps)
    else:
        wind = 1.0
    out = out_full[:numtaps] * wind
    if ftype == 3:
        out[numtaps // 2] = 0.0
    return out


def kaiserord(ripple: float, width: float) -> tuple[int, float]:
    """Kaiser-window FIR order estimate (scipy.signal.kaiserord parity):
    given the max ripple in dB and the transition width as a fraction of
    the Nyquist rate, return (numtaps, beta) for `firwin`."""
    A = abs(float(ripple))
    if A < 8:
        raise ValueError("ripple attenuation too small for the Kaiser "
                         "formula (need at least 8 dB)")
    beta = kaiser_beta(A)
    numtaps = (A - 7.95) / 2.285 / (np.pi * float(width)) + 1
    return int(np.ceil(numtaps)), beta


def firls(numtaps: int, bands, desired, *, weight=None,
          fs: float = 2.0) -> np.ndarray:
    """Least-squares linear-phase FIR design (scipy.signal.firls parity).

    Minimizes the weighted integrated squared error between the type-I
    amplitude response A(f) = a0 + sum_k a_k cos(pi k f) and the
    piecewise-linear desired response over the given bands.  The normal
    equations have the classic Toeplitz-plus-Hankel structure
    Q = (T(q) + H(q))/2 with q the band-integrated cosine moments, solved
    in float64 on the host like every design routine here.
    """
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("numtaps must be odd and >= 1")
    M = (numtaps - 1) // 2
    nyq = 0.5 * fs
    bands = np.asarray(bands, np.float64).ravel() / nyq
    if bands.size % 2:
        raise ValueError("bands must contain frequency pairs")
    if np.any(bands < 0) or np.any(bands > 1):
        raise ValueError("bands must lie within [0, fs/2]")
    if np.any(np.diff(bands) < 0):
        raise ValueError("bands must be monotonically nondecreasing")
    bands = bands.reshape(-1, 2)
    desired = np.asarray(desired, np.float64).ravel().reshape(-1, 2)
    if desired.shape[0] != bands.shape[0]:
        raise ValueError("desired must have one value per band edge")
    if weight is None:
        weight = np.ones(bands.shape[0], np.float64)
    weight = np.asarray(weight, np.float64).ravel()
    if weight.size != bands.shape[0]:
        raise ValueError("weight must have one value per band")

    # q[m] = sum_b w_b * \int_band cos(pi m f) df, m = 0 .. 2M
    m = np.arange(2 * M + 1, dtype=np.float64)[None, :]
    f0 = bands[:, :1]
    f1 = bands[:, 1:]
    with np.errstate(invalid="ignore", divide="ignore"):
        integ = (np.sin(np.pi * m * f1) - np.sin(np.pi * m * f0)) \
            / (np.pi * m)
    integ[:, 0] = (f1 - f0)[:, 0]
    q = (weight[:, None] * integ).sum(axis=0)

    # b[j] = sum_b w_b * \int_band D(f) cos(pi j f) df with D linear/band
    j = np.arange(M + 1, dtype=np.float64)[None, :]
    d0 = desired[:, :1]
    d1 = desired[:, 1:]
    slope = np.where(f1 > f0, (d1 - d0) / np.where(f1 > f0, f1 - f0, 1.0),
                     0.0)
    c0 = d0 - slope * f0  # D(f) = c0 + slope * f

    def _int_cos(f, j):  # \int cos(pi j f) df
        with np.errstate(invalid="ignore", divide="ignore"):
            v = np.sin(np.pi * j * f) / (np.pi * j)
        return np.where(j == 0, f, v)

    def _int_fcos(f, j):  # \int f cos(pi j f) df
        with np.errstate(invalid="ignore", divide="ignore"):
            v = (np.cos(np.pi * j * f) / (np.pi * j) ** 2
                 + f * np.sin(np.pi * j * f) / (np.pi * j))
        return np.where(j == 0, 0.5 * f * f, v)

    bint = (c0 * (_int_cos(f1, j) - _int_cos(f0, j))
            + slope * (_int_fcos(f1, j) - _int_fcos(f0, j)))
    bvec = (weight[:, None] * bint).sum(axis=0)

    # Q_{jk} = (q[|j-k|] + q[j+k]) / 2  (Toeplitz + Hankel)
    idx = np.arange(M + 1)
    Q = 0.5 * (q[np.abs(idx[:, None] - idx[None, :])]
               + q[idx[:, None] + idx[None, :]])
    a = np.linalg.solve(Q, bvec)

    h = np.empty(numtaps, np.float64)
    h[M] = a[0]
    h[M + 1:] = 0.5 * a[1:]
    h[:M] = 0.5 * a[:0:-1]
    return h


def _bary_gamma(xe):
    """Barycentric weights 1/prod(x_k - x_j) via logs (overflow-safe for
    hundreds of nodes), returned scaled by a common factor (all uses are
    ratios of gamma-weighted sums, so the scale cancels)."""
    d = xe[:, None] - xe[None, :]
    np.fill_diagonal(d, 1.0)
    logg = -np.sum(np.log(np.abs(d)), axis=1)
    sg = np.prod(np.sign(d), axis=1)
    return sg * np.exp(logg - logg.max())


def _bary_eval(x, xe, ce, gam):
    """Second-form barycentric interpolation through (xe, ce) at x."""
    diff = x[:, None] - xe[None, :]
    hit = np.abs(diff) < 1e-14
    diff = np.where(hit, 1.0, diff)
    t = gam[None, :] / diff
    p = (t @ ce) / t.sum(axis=1)
    rows = hit.any(axis=1)
    if rows.any():
        p[rows] = ce[np.argmax(hit[rows], axis=1)]
    return p


def remez(numtaps: int, bands, desired, *, weight=None, type="bandpass",
          maxiter: int = 25, grid_density: int = 16,
          fs: float = 1.0) -> np.ndarray:
    """Parks-McClellan optimal equiripple FIR design
    (scipy.signal.remez parity).

    Classic Remez exchange on a dense frequency grid: the amplitude is
    factored A(f) = G(f) P(f) (G = 1, cos(pi f), sin(2pi f), sin(pi f)
    for filter types I-IV), P is the degree-(r-1) cosine polynomial that
    equioscillates through r+1 extremal points, and the exchange
    iterates barycentric leveled-error fits until the extremal set is
    stationary.  Taps are recovered by frequency sampling A at k/N.
    All float64 host math like the other design routines.
    """
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    if type not in ("bandpass", "differentiator", "hilbert"):
        raise ValueError(f"invalid filter type {type!r}")
    bands = np.asarray(bands, np.float64).ravel() / fs  # -> [0, 0.5]
    if bands.size % 2 or bands.size < 2:
        raise ValueError("bands must contain frequency pairs")
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 0.5:
        raise ValueError("bands must be nondecreasing within [0, fs/2]")
    nb = bands.size // 2
    desired = np.asarray(desired, np.float64).ravel()
    if desired.size != nb:
        raise ValueError("desired must have one value per band")
    if weight is None:
        weight = np.ones(nb, np.float64)
    weight = np.asarray(weight, np.float64).ravel()
    if weight.size != nb:
        raise ValueError("weight must have one value per band")

    odd = numtaps % 2
    if type == "bandpass":
        L = 1 if odd else 2
    else:
        L = 3 if odd else 4
    r = {1: (numtaps + 1) // 2, 2: numtaps // 2,
         3: (numtaps - 1) // 2, 4: numtaps // 2}[L]
    if r < 1:
        raise ValueError("filter order too small for this type")

    # dense grid (classic construction: step 0.5/(grid_density*r))
    delf = 0.5 / (grid_density * r)
    gf, gD, gW = [], [], []
    for b in range(nb):
        f0, f1 = bands[2 * b], bands[2 * b + 1]
        pts = np.arange(f0, f1, delf)
        if pts.size == 0 or pts[-1] < f1 - 1e-15:
            pts = np.concatenate([pts, [f1]])
        if type == "differentiator" and desired[b] >= 1e-4:
            D = desired[b] * pts
            W = weight[b] / np.maximum(pts, 1e-20)
        else:
            D = np.full(pts.size, desired[b])
            W = np.full(pts.size, weight[b])
        gf.append(pts)
        gD.append(D)
        gW.append(W)
    f = np.concatenate(gf)
    D = np.concatenate(gD)
    W = np.concatenate(gW)

    # G(f) transform; drop grid points where G ~ 0 (singular endpoints)
    if L == 1:
        G = np.ones_like(f)
    elif L == 2:
        G = np.cos(np.pi * f)
    elif L == 3:
        G = np.sin(2 * np.pi * f)
    else:
        G = np.sin(np.pi * f)
    keep = np.abs(G) > 1e-9
    f, D, W, G = f[keep], D[keep], W[keep], G[keep]
    Dp = D / G
    Wp = W * G if L == 1 else W * np.abs(G)
    ngrid = f.size
    if ngrid < r + 1:
        raise ValueError("grid too coarse for the requested order; "
                         "increase grid_density")
    x = np.cos(2 * np.pi * f)

    # band-edge grid indices are always extremal candidates
    edges = set()
    for b in range(nb):
        f0, f1 = bands[2 * b], bands[2 * b + 1]
        edges.add(int(np.argmin(np.abs(f - f0))))
        edges.add(int(np.argmin(np.abs(f - f1))))

    ext = np.round(np.linspace(0, ngrid - 1, r + 1)).astype(int)
    alt = np.array([(-1.0) ** k for k in range(r + 1)])
    E = np.zeros(ngrid)
    for _ in range(maxiter):
        xe = x[ext]
        gam = _bary_gamma(xe)
        delta = np.sum(gam * Dp[ext]) / np.sum(gam * alt / Wp[ext])
        C = Dp[ext] - alt * delta / Wp[ext]
        P = _bary_eval(x, xe, C, gam)
        E = Wp * (Dp - P)

        # candidates: local maxima of |E| + band edges + current set
        aE = np.abs(E)
        loc = np.zeros(ngrid, bool)
        loc[1:-1] = (aE[1:-1] >= aE[:-2]) & (aE[1:-1] >= aE[2:])
        loc[0] = aE[0] >= aE[1]
        loc[-1] = aE[-1] >= aE[-2]
        cands = sorted(set(np.flatnonzero(loc)) | edges | set(ext))
        sel: list[int] = []
        for i in cands:
            if aE[i] == 0.0 and len(sel) > 0:
                continue
            if sel and np.sign(E[i]) == np.sign(E[sel[-1]]):
                if aE[i] > aE[sel[-1]]:
                    sel[-1] = i
            else:
                sel.append(i)
        while len(sel) > r + 1:
            if aE[sel[0]] < aE[sel[-1]]:
                sel.pop(0)
            else:
                sel.pop()
        if len(sel) < r + 1:
            break  # degenerate; keep the current leveled fit
        new_ext = np.asarray(sel)
        if np.array_equal(new_ext, ext):
            break
        ext = new_ext

    # Taps from the EXACT leveled values at the extremal points:
    # A(f_e) = G(f_e) C_e (P interpolates C there by construction), so the
    # (r+1) x r cosine/sine Vandermonde system is consistent and lstsq
    # recovers the taps at delta-level accuracy.  (Sampling A at k/N and
    # inverse-FFT'ing instead needs barycentric EXTRAPOLATION far outside
    # the node hull when the bands are narrow — measured 1e4x noisier on
    # a [0.025, 0.225] differentiator.)
    xe = x[ext]
    gam = _bary_gamma(xe)
    delta = np.sum(gam * Dp[ext]) / np.sum(gam * alt / Wp[ext])
    C = Dp[ext] - alt * delta / Wp[ext]
    fe = f[ext]
    if L == 1:
        Ge = np.ones_like(fe)
    elif L == 2:
        Ge = np.cos(np.pi * fe)
    elif L == 3:
        Ge = np.sin(2 * np.pi * fe)
    else:
        Ge = np.sin(np.pi * fe)
    Ae = Ge * C

    h = np.zeros(numtaps, np.float64)
    if L == 1:
        M = (numtaps - 1) // 2
        V = np.concatenate(
            [np.ones((fe.size, 1)),
             2 * np.cos(2 * np.pi * np.outer(fe, np.arange(1, M + 1)))],
            axis=1)
        coef = np.linalg.lstsq(V, Ae, rcond=None)[0]
        h[M] = coef[0]
        h[M + 1:] = coef[1:]
        h[:M] = coef[:0:-1]
    elif L == 2:
        half = numtaps // 2
        V = 2 * np.cos(2 * np.pi * np.outer(fe,
                                            np.arange(1, half + 1) - 0.5))
        coef = np.linalg.lstsq(V, Ae, rcond=None)[0]
        h[half:] = coef
        h[:half] = coef[::-1]
    elif L == 3:
        M = numtaps // 2
        V = 2 * np.sin(2 * np.pi * np.outer(fe, np.arange(1, M + 1)))
        coef = np.linalg.lstsq(V, Ae, rcond=None)[0]
        # scipy sign convention (H = i A e^{-i pi f (N-1)})
        h[M + 1:] = -coef
        h[:M] = coef[::-1]
    else:
        half = numtaps // 2
        V = 2 * np.sin(2 * np.pi * np.outer(fe,
                                            np.arange(1, half + 1) - 0.5))
        coef = np.linalg.lstsq(V, Ae, rcond=None)[0]
        h[half:] = -coef
        h[:half] = coef[::-1]
    return h

def _output_len(n_h: int, n_in: int, up: int, down: int) -> int:
    """Standard upfirdn output length (scipy _upfirdn._output_len)."""
    return (((n_in - 1) * up + n_h) + down - 1) // down


def _stuff_pad(v, up: int, n: int, nfft: int):
    """Zero-stuff the last axis by `up` and zero-pad to nfft."""
    if up > 1:
        z = jnp.zeros(v.shape[:-1] + (n, up), v.dtype)
        z = z.at[..., 0].set(v)
        v = z.reshape(v.shape[:-1] + (n * up,))[..., : (n - 1) * up + 1]
    pad = [(0, 0)] * (v.ndim - 1) + [(0, nfft - v.shape[-1])]
    return jnp.pad(v, pad)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _upfirdn_real(v, hw, up, down, n, n_h, nfft):
    from .rfft import irfft_last_split, rfft_last_split

    xu = _stuff_pad(v, up, n, nfft)
    hp = jnp.pad(hw, (0, nfft - n_h))
    Xr, Xi = rfft_last_split(xu, None)
    Hr, Hi = rfft_last_split(hp[None], None)  # one row, broadcasts below
    Hr, Hi = Hr[0], Hi[0]
    Yr = Xr * Hr - Xi * Hi
    Yi = Xr * Hi + Xi * Hr
    y = irfft_last_split(Yr, Yi, nfft, 1.0 / nfft)
    L = (n - 1) * up + n_h
    return y[..., :L:down]


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _upfirdn_cplx(vr, vi, hr, hi, up, down, n, n_h, nfft):
    from .nd import fftn_split

    ax = (vr.ndim - 1,)
    xr = _stuff_pad(vr, up, n, nfft)
    xi = _stuff_pad(vi, up, n, nfft)
    hpr = jnp.pad(hr, (0, nfft - n_h))[None]
    hpi = jnp.pad(hi, (0, nfft - n_h))[None]
    Xr, Xi = fftn_split(xr, xi, ax, -1, None)
    Hr, Hi = fftn_split(hpr, hpi, (1,), -1, None)
    Hr, Hi = Hr[0], Hi[0]
    Yr = Xr * Hr - Xi * Hi
    Yi = Xr * Hi + Xi * Hr
    yr, yi = fftn_split(Yr, -Yi, ax, -1, 1.0 / nfft)  # ifft via conjugation
    L = (n - 1) * up + n_h
    return yr[..., :L:down], -yi[..., :L:down]


_PAD_MODES = {
    "constant", "edge", "wrap", "symmetric", "reflect",
    "antisymmetric", "antireflect", "smooth",
}


def _extend(x, k: int, axis: int, mode: str, cval):
    """Explicitly pre-extend `x` by k samples per side along `axis`
    (scipy upfirdn's virtual signal-extension modes, materialized)."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (k, k)
    if mode == "constant":
        return jnp.pad(x, pad, constant_values=cval)
    if mode in ("edge", "wrap", "symmetric", "reflect"):
        return jnp.pad(x, pad, mode=mode)
    if mode == "antisymmetric":
        # whole-sample odd extension (sign-flipped symmetric reflection).
        # The infinite extension is periodic with period 2n:
        # [x, -flip(x)] (verified against scipy with a delayed-delta
        # filter) — realize any k, even k > n where the reflection folds
        # repeatedly, by tiling that period.
        xm = jnp.moveaxis(x, axis, -1)
        nn = xm.shape[-1]
        period = jnp.concatenate([xm, -xm[..., ::-1]], -1)  # length 2n
        base = 2 * nn * ((k + 2 * nn - 1) // (2 * nn))  # multiple of 2n >= k
        reps = (base + nn + k + 2 * nn - 1) // (2 * nn)
        tiled = jnp.tile(period, (1,) * (xm.ndim - 1) + (reps,))
        out = tiled[..., base - k: base + nn + k]
        return jnp.moveaxis(out, -1, axis)
    if mode == "antireflect":
        return jnp.pad(x, pad, mode="reflect", reflect_type="odd")
    if mode == "smooth":
        # extend with the edge slope: x[-1] + i*(x[-1]-x[-2]) etc.
        xm = jnp.moveaxis(x, axis, -1)
        i = jnp.arange(1, k + 1, dtype=xm.dtype)
        left = xm[..., :1] - i[::-1] * (xm[..., 1:2] - xm[..., :1])
        right = xm[..., -1:] + i * (xm[..., -1:] - xm[..., -2:-1])
        return jnp.moveaxis(jnp.concatenate([left, xm, right], -1), -1, axis)
    raise ValueError(f"unsupported mode {mode!r} (supported: "
                     f"{sorted(_PAD_MODES)})")


def upfirdn(h, x, up: int = 1, down: int = 1, axis: int = -1,
            mode: str = "constant", cval: float = 0.0):
    """Upsample by `up` (zero-stuffing), FIR filter with `h`, downsample by
    `down` (scipy.signal.upfirdn parity, FFT-based).

    Output length along `axis` is ``ceil(((n-1)*up + len(h)) / down)``.
    `mode`/`cval` select the signal-extension convention; the default
    ('constant', 0) is the classic zero-extended upfirdn.
    """
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    x = _as_host_or_device(x)
    # taps are design-time host tables (like every window/trig table)
    h_host = np.asarray(h)
    if h_host.ndim != 1 or h_host.size == 0:
        raise ValueError("h must be a non-empty 1-D tap array")
    n_h = int(h_host.shape[0])
    n = x.shape[axis]

    if mode != "constant" or float(cval) != 0.0:
        # materialize the extension: k input samples per side, k a multiple
        # of `down` so the padded output grid realigns with the unpadded one
        k = ((n_h + down - 1) // down) * down
        if _iscomplex(x):
            from ..core.complex_utils import split
            xr, xi = split(x)  # host complex splits on the host
            xr = _extend(xr, k, axis, mode, cval)
            xi = _extend(xi, k, axis, mode, 0.0)
            from ..core.complex_utils import merge
            xext = merge(xr, xi)  # jitted merge (no complex H2D, no eager)
        else:
            xext = _extend(jnp.asarray(x, jnp.float32), k, axis, mode, cval)
        n_out = _output_len(n_h, n, up, down)
        off = k * up // down
        y = upfirdn(h_host, xext, up, down, axis)  # zero-ext on padded x
        sl = [slice(None)] * y.ndim
        sl[axis] = slice(off, off + n_out)
        return y[tuple(sl)]

    lfull = (n - 1) * up + n_h
    nfft = 1 << max(1, math.ceil(math.log2(lfull)))

    cplx = _iscomplex(x) or np.iscomplexobj(h_host)
    if not cplx:
        v = jnp.moveaxis(jnp.asarray(x, jnp.float32), axis, -1)
        hw = jnp.asarray(np.asarray(h_host, np.float64), jnp.float32)
        y = _upfirdn_real(v, hw, up, down, n, n_h, nfft)
        return jnp.moveaxis(y, -1, axis)

    from ..core.complex_utils import split
    vr, vi = split(x)
    vr = jnp.moveaxis(jnp.asarray(vr, jnp.float32), axis, -1)
    vi = jnp.moveaxis(jnp.asarray(vi, jnp.float32), axis, -1)
    hh = np.asarray(h_host, np.complex128)
    hr = jnp.asarray(hh.real.astype(np.float64), jnp.float32)
    hi = jnp.asarray(hh.imag.astype(np.float64), jnp.float32)
    yr, yi = _upfirdn_cplx(vr, vi, hr, hi, up, down, n, n_h, nfft)
    from ..core.complex_utils import merge
    return jnp.moveaxis(merge(yr, yi), -1, axis)


# ---------------------------------------------------------------------------
# resample_poly
# ---------------------------------------------------------------------------

_STAT_PADTYPES = {
    "mean": jnp.mean,
    "median": jnp.median,
    "maximum": jnp.max,
    "minimum": jnp.min,
}


def resample_poly(x, up: int, down: int, axis: int = -1,
                  window=("kaiser", 5.0), padtype: str = "constant",
                  cval=None):
    """Rational-rate resampling via upfirdn (scipy.signal.resample_poly
    parity): anti-alias FIR designed by `firwin`, output samples centered
    by filter pre-padding."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    g = math.gcd(up, down)
    up //= g
    down //= g
    x = _as_host_or_device(x)
    if up == down == 1:
        if _iscomplex(x):  # no complex H2D transfer (CLAUDE.md)
            from ..core.complex_utils import merge, split
            return merge(*split(x))
        return jnp.asarray(x)
    n_in = x.shape[axis]
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)

    if isinstance(window, (list, np.ndarray, jnp.ndarray)):
        h = np.asarray(window, np.float64)
        if h.ndim != 1:
            raise ValueError("window as an array must be the 1-D filter")
        half_len = (h.size - 1) // 2
    else:
        max_rate = max(up, down)
        f_c = 1.0 / max_rate        # relative to Nyquist (firwin fs=2)
        half_len = 10 * max_rate
        h = firwin(2 * half_len + 1, f_c, window=window)
    h = h * up

    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (_output_len(h.size + n_pre_pad + n_post_pad, n_in, up, down)
           < n_out + n_pre_remove):
        n_post_pad += 1
    h = np.concatenate((np.zeros(n_pre_pad), h, np.zeros(n_post_pad)))

    background = None
    kwargs = {}
    if padtype in _STAT_PADTYPES:
        if _iscomplex(x):
            if padtype != "mean":
                raise ValueError(f"padtype {padtype!r} needs real input "
                                 "(ordering is undefined for complex)")
            # stay split: eager complex device ops are unsupported on
            # some runtimes (core/complex_utils.py)
            from ..core.complex_utils import merge, split
            xr, xi = split(x)
            br = jnp.mean(xr, axis=axis, keepdims=True)
            bi = jnp.mean(xi, axis=axis, keepdims=True)
            x = merge(xr - br, xi - bi)
            background = (br, bi)
        else:
            xd = jnp.asarray(x, jnp.float32)
            background = _STAT_PADTYPES[padtype](xd, axis=axis,
                                                 keepdims=True)
            x = xd - background
    elif padtype == "constant":
        kwargs = {"mode": "constant", "cval": 0.0 if cval is None else cval}
    elif padtype in _PAD_MODES:
        kwargs = {"mode": padtype}
    else:
        raise ValueError(f"invalid padtype {padtype!r}")

    y = upfirdn(h, x, up, down, axis=axis, **kwargs)
    sl = [slice(None)] * y.ndim
    sl[axis] = slice(n_pre_remove, n_pre_remove + n_out)
    y = y[tuple(sl)]
    if isinstance(background, tuple):  # complex mean, re-added under jit
        y = jax.jit(lambda v, a, b: v + jax.lax.complex(a, b))(
            y, *background)
    elif background is not None:
        y = y + background
    return y


def decimate(x, q: int, n: int | None = None, ftype: str = "fir",
             axis: int = -1, zero_phase: bool = True):
    """Downsample after an anti-aliasing FIR filter
    (scipy.signal.decimate, ftype='fir' path).

    The default IIR path in scipy (Chebyshev-I sosfiltfilt) is a recursive
    filter — inherently sequential per sample, the opposite of what an
    accelerator wants; this framework implements the FIR path (scipy's own
    recommendation for sample-rate conversion) and raises for 'iir'.
    """
    q = int(q)
    if q < 1:
        raise ValueError("q must be >= 1")
    if ftype != "fir":
        raise NotImplementedError(
            "decimate supports ftype='fir' only (IIR filtering is "
            "sample-sequential; use ftype='fir' or resample_poly)")
    if n is None:
        n = 2 * (10 * q)
    h = firwin(n + 1, 1.0 / q, window="hamming")
    x = _as_host_or_device(x)
    if zero_phase:
        return resample_poly(x, 1, q, axis=axis, window=h)
    n_out = x.shape[axis] // q + bool(x.shape[axis] % q)
    y = upfirdn(h, x, up=1, down=q, axis=axis)
    sl = [slice(None)] * y.ndim
    sl[axis] = slice(None, n_out)
    return y[tuple(sl)]


# ---------------------------------------------------------------------------
# Frequency-response analysis (host f64, design-time companions to firwin)
# ---------------------------------------------------------------------------

def freqz(b, a=1, worN: int | np.ndarray = 512, whole: bool = False,
          fs: float = 2 * np.pi, include_nyquist: bool = False):
    """Frequency response of a digital filter (scipy.signal.freqz parity):
    ``H(e^{jw}) = B(e^{-jw}) / A(e^{-jw})``.

    Host float64 analysis math (like the FIR design functions — this
    parameterizes/validates filters, it is not device compute).  Returns
    (w, h) with `w` in the units of `fs`.
    """
    b = np.atleast_1d(np.asarray(b))
    a = np.atleast_1d(np.asarray(a))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D")
    if np.isscalar(worN) or np.ndim(worN) == 0:
        N = int(worN)
        if N < 0:
            raise ValueError("worN must be nonnegative")
        lastpoint = 2 * np.pi if whole else np.pi
        if include_nyquist and not whole:
            w = np.linspace(0, lastpoint, N, endpoint=True)
        else:
            w = np.linspace(0, lastpoint, N, endpoint=False)
    else:
        w = 2 * np.pi * np.atleast_1d(np.asarray(worN, np.float64)) / fs
    z = np.exp(-1j * w)
    h = np.polyval(b[::-1], z) / np.polyval(a[::-1], z)
    return w * (fs / (2 * np.pi)), h


def group_delay(system, w: int | np.ndarray = 512, whole: bool = False,
                fs: float = 2 * np.pi):
    """Group delay of a digital filter (scipy.signal.group_delay parity):
    ``-d(angle(H))/dw`` via the Re(C'(z)/C(z)) identity with
    ``c = conv(b, conj(reversed(a)))``.  Host float64 analysis math."""
    b, a = map(np.atleast_1d, system)
    if np.isscalar(w) or np.ndim(w) == 0:
        N = int(w)
        last = 2 * np.pi if whole else np.pi
        w = np.linspace(0, last, N, endpoint=False)
    else:
        w = 2 * np.pi * np.atleast_1d(np.asarray(w, np.float64)) / fs
    c = np.convolve(b, np.conjugate(a[::-1]))
    cr = c * np.arange(c.size)
    z = np.exp(-1j * w)
    num = np.polyval(cr[::-1], z)
    den = np.polyval(c[::-1], z)
    with np.errstate(divide="ignore", invalid="ignore"):
        gd = np.real(num / den) - a.size + 1
    singular = ~np.isfinite(gd)
    if np.any(singular):
        import warnings

        gd[singular] = 0
        warnings.warn("group delay is singular at some frequencies; "
                      "set to 0 there", stacklevel=2)
    return w * (fs / (2 * np.pi)), gd
