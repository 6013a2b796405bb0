"""2-D convolution/correlation with boundary handling, polynomial
deconvolution, Wiener filtering, and Savitzky-Golay smoothing.

scipy.signal parity layer (convolve2d / correlate2d / deconvolve / wiener /
savgol_coeffs / savgol_filter / morlet).  The reference (fft_wgpu) has no
convolution layer at all — these ride the framework's FFT kernels
(`helpers.fftconvolve`) the way cuFFT-based stacks ride cufftExecC2C, so the
hot path is the library's own R2C/C2C pipeline.  Filter/window DESIGN (savgol_coeffs, morlet, edge-fit
matrices) is host-side f64, matching the framework's trig-table rule
(CLAUDE.md): device work is one jitted program per geometry.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge, promote_to_split
from .helpers import _as_host_or_device, _iscomplex, fftconvolve, \
    next_fast_len

__all__ = [
    "convolve2d",
    "correlate2d",
    "deconvolve",
    "wiener",
    "savgol_coeffs",
    "savgol_filter",
    "morlet",
]


def _pad2d_planes(ar, ai, p1: int, p2: int, boundary: str, fr, fi):
    """Pad split (re, im) float planes by (p1, p2) per side with scipy
    convolve2d's boundary semantics ('fill' | 'wrap' | 'symm').  Runs
    under trace on real planes only — complex inputs were split on the
    HOST before entering the jitted program (CLAUDE.md: complex arrays
    never cross host<->device)."""
    pads = ((p1, p1), (p2, p2))
    if boundary == "fill":
        re = jnp.pad(ar, pads, constant_values=fr)
        im = None if ai is None and fi == 0 else jnp.pad(
            ar * 0 if ai is None else ai, pads, constant_values=fi)
        return re, im
    mode = {"wrap": "wrap", "symm": "symmetric"}.get(boundary)
    if mode is None:
        raise ValueError(f"unknown boundary {boundary!r}")
    return (jnp.pad(ar, pads, mode=mode),
            None if ai is None else jnp.pad(ai, pads, mode=mode))


def _spectral_conv2d_full(ar, ai, br, bi):
    """Full 2-D linear convolution of split-complex planes (under trace).
    Real x real rides the R2C pipeline; anything complex runs C2C on
    merged values (complex compute inside jit is fine — only the
    host<->device boundary is planar)."""
    from .nd import fftn, ifftn
    from .rfft import irfftn, rfftn

    lfull = [ar.shape[0] + br.shape[0] - 1, ar.shape[1] + br.shape[1] - 1]
    shape = [next_fast_len(l, real=True) for l in lfull]
    if ai is None and bi is None:
        fa = rfftn(ar, s=shape, axes=(-2, -1))
        fb = rfftn(br, s=shape, axes=(-2, -1))
        out = irfftn(fa * fb, s=shape, axes=(-2, -1))
        return out[: lfull[0], : lfull[1]], None
    za = merge(ar, jnp.zeros_like(ar) if ai is None else ai)
    zb = merge(br, jnp.zeros_like(br) if bi is None else bi)
    out = ifftn(fftn(za, s=shape, axes=(-2, -1))
                * fftn(zb, s=shape, axes=(-2, -1)), axes=(-2, -1))
    out = out[: lfull[0], : lfull[1]]
    return jnp.real(out), jnp.imag(out)


def _conv2d_impl(in1, in2, mode: str, boundary: str, fillvalue,
                 corr: bool = False):
    """Shared convolve2d/correlate2d engine: ONE jitted program per
    geometry (pad + spectral convolution + crop all under trace — a
    single dispatch), with complex inputs split on
    the host first (np.real/np.imag never touch the device)."""
    in1 = _as_host_or_device(in1)
    in2 = _as_host_or_device(in2)
    if jnp.ndim(in1) != 2 or jnp.ndim(in2) != 2:
        raise ValueError("convolve2d inputs must both be 2-D")
    n1, n2 = in1.shape
    k1, k2 = in2.shape
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "valid" and not (
            (n1 >= k1 and n2 >= k2) or (k1 >= n1 and k2 >= n2)):
        raise ValueError(
            "valid mode needs one input at least as large as the other "
            "in every dimension")

    fr = float(np.real(fillvalue))
    fi = float(np.imag(fillvalue))
    cplx = _iscomplex(in1) or _iscomplex(in2) or fi != 0.0
    if cplx:
        a_r, a_i = promote_to_split(in1)  # host numpy splits on the host
        b_r, b_i = promote_to_split(in2)
    else:
        a_r, a_i = jnp.asarray(in1, jnp.float32), None
        b_r, b_i = jnp.asarray(in2, jnp.float32), None

    # correlation's 'same' window sits one sample later than
    # convolution's when a kernel dim is even (scipy convention:
    # offset k//2 vs convolve's (k-1)//2)
    s1 = k1 // 2 if corr else (k1 - 1) // 2
    s2 = k2 // 2 if corr else (k2 - 1) // 2
    zero_fill = boundary == "fill" and fr == 0 and fi == 0

    def impl(ar, ai, br, bi):
        if corr:
            # correlate(a, b) == convolve(a, conj(b reversed)); XLA `rev`
            # is fine under jit (only Mosaic kernels lack it)
            br = br[::-1, ::-1]
            bi = None if bi is None else -bi[::-1, ::-1]
        if zero_fill:
            fullr, fulli = _spectral_conv2d_full(ar, ai, br, bi)
            r0, c0 = 0, 0
        else:
            # Non-trivial boundary: pad by (k-1) per side (the kernel's
            # full reach), run a zero-boundary convolution, and crop the
            # window of the padded 'full' result corresponding to the
            # requested mode on the ORIGINAL signal (full output sample t
            # appears at t + (k-1) in the padded full output).
            ar, ai = _pad2d_planes(ar, ai, k1 - 1, k2 - 1, boundary, fr, fi)
            fullr, fulli = _spectral_conv2d_full(ar, ai, br, bi)
            r0, c0 = k1 - 1, k2 - 1
        h, w = n1 + k1 - 1, n2 + k2 - 1
        if mode == "same":
            r0, c0 = r0 + s1, c0 + s2
            h, w = n1, n2
        elif mode == "valid":
            h, w = abs(n1 - k1) + 1, abs(n2 - k2) + 1
            r0, c0 = r0 + min(n1, k1) - 1, c0 + min(n2, k2) - 1
        outr = fullr[r0:r0 + h, c0:c0 + w]
        if fulli is None:
            return outr
        return merge(outr, fulli[r0:r0 + h, c0:c0 + w])

    args = [p for p in (a_r, a_i, b_r, b_i) if p is not None]
    if cplx:
        return jax.jit(impl)(a_r, a_i, b_r, b_i)
    return jax.jit(lambda ar, br: impl(ar, None, br, None))(*args)


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill",
               fillvalue=0):
    """2-D linear convolution (scipy.signal.convolve2d parity) via the
    framework's FFT pipeline, with 'fill'/'wrap'/'symm' boundaries."""
    return _conv2d_impl(in1, in2, mode, boundary, fillvalue)


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill",
                fillvalue=0):
    """2-D cross-correlation (scipy.signal.correlate2d parity):
    convolution against the conjugated, axis-reversed template (the
    flip/conj happens on split planes inside the jitted program — a host
    complex template is never conjugated through a device transfer)."""
    return _conv2d_impl(in1, in2, mode, boundary, fillvalue, corr=True)


def deconvolve(signal, divisor):
    """Polynomial long division: signal = convolve(divisor, quotient)
    + remainder (scipy.signal.deconvolve parity).

    Inherently sequential recurrence on tiny 1-D inputs — runs host-side
    in f64 like all design-time math in this framework.
    """
    num = np.atleast_1d(np.asarray(signal))
    den = np.atleast_1d(np.asarray(divisor))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("deconvolve inputs must be 1-D")
    if den.size == 0 or den[0] == 0:
        raise ValueError("divisor must have a nonzero leading coefficient")
    L = num.size - den.size + 1
    dt = np.result_type(num.dtype, den.dtype, np.float64)
    if L < 1:
        return np.zeros(0, dtype=dt), num.astype(dt)
    rem = num.astype(dt).copy()
    quot = np.zeros(L, dtype=dt)
    d0 = den.astype(dt)
    for k in range(L):
        q = rem[k] / d0[0]
        quot[k] = q
        rem[k:k + den.size] -= q * d0
    return quot, rem


def wiener(im, mysize=None, noise=None):
    """Adaptive local-statistics Wiener filter (scipy.signal.wiener
    parity): local mean/mean-square box windows via ONE jitted spectral
    program (the image transforms once, the box spectrum multiplies both
    moments — half the transforms of two separate convolutions, and one
    dispatch instead of ~10).

    scipy computes the windows with `correlate(im, ones, 'same')` —
    which equals `convolve` with the flipped (== identical, symmetric box)
    kernel, i.e. the full-output crop at offset (k-1)//2 per axis;
    verified against the scipy oracle for even window sizes in
    tests/test_conv2d.py::test_wiener_even_window_matches_scipy."""
    im = _as_host_or_device(im)
    if _iscomplex(im):
        # scipy's own lVar < noise comparison is undefined on complex;
        # fail clearly instead of producing a broken transfer.
        raise ValueError("wiener expects real input")
    nd = jnp.ndim(im)
    if mysize is None:
        mysize = (3,) * nd
    elif np.isscalar(mysize):
        mysize = (int(mysize),) * nd
    mysize = tuple(int(m) for m in mysize)
    if len(mysize) != nd:
        raise ValueError("mysize must match the input rank")
    size = math.prod(mysize)
    dims = tuple(im.shape)

    def impl(x):
        from .rfft import irfftn, rfftn

        lfull = [dims[a] + mysize[a] - 1 for a in range(nd)]
        shape = [next_fast_len(l, real=True) for l in lfull]
        axes = tuple(range(nd))
        box = jnp.ones(mysize, jnp.float32)
        fbox = rfftn(box, s=shape, axes=axes)
        crop = tuple(slice((m - 1) // 2, (m - 1) // 2 + d)
                     for m, d in zip(mysize, dims))
        l_mean = irfftn(rfftn(x, s=shape, axes=axes) * fbox,
                        s=shape, axes=axes)[crop] / size
        l_sq = irfftn(rfftn(x * x, s=shape, axes=axes) * fbox,
                      s=shape, axes=axes)[crop] / size
        l_var = l_sq - l_mean * l_mean  # unclamped, like scipy
        nz = jnp.mean(l_var) if noise is None else jnp.float32(noise)
        res = l_mean + (x - l_mean) * (1.0 - nz / jnp.maximum(l_var, nz))
        return jnp.where(l_var < nz, l_mean, res)

    return jax.jit(impl)(jnp.asarray(im, jnp.float32))


def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, pos=None, use: str = "conv"):
    """Savitzky-Golay FIR coefficients (scipy.signal.savgol_coeffs
    parity), designed host-side in f64 via the Vandermonde pseudo-inverse
    (the framework's design-time-math rule)."""
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        if rem == 0:
            pos = halflen - 0.5
        else:
            pos = halflen
    if not (0 <= pos < window_length):
        raise ValueError("pos must be nonnegative and less than "
                         "window_length")
    if deriv > polyorder:
        return np.zeros(window_length)
    # rows of A are powers of (x - pos); solve A^T a = y for the impulse
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x ** order
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (delta ** deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def _savgol_edge_fit(window_length: int, polyorder: int, deriv: int,
                     delta: float):
    """[window_length, window_length] f64 matrix E with row i = the
    deriv-th derivative at sample i of the least-squares degree-polyorder
    polynomial fit to a window (scipy's 'interp' edge handling, as one
    host-designed matmul)."""
    t = np.arange(window_length, dtype=np.float64)
    A = t.reshape(-1, 1) ** np.arange(polyorder + 1)
    pinv = np.linalg.pinv(A)  # [polyorder+1, wl]
    # derivative operator on the coefficient vector
    rows = []
    for i in range(window_length):
        basis = np.zeros(polyorder + 1)
        for j in range(deriv, polyorder + 1):
            basis[j] = (math.factorial(j) / math.factorial(j - deriv)
                        * t[i] ** (j - deriv)) / delta ** deriv
        rows.append(basis @ pinv)
    return np.stack(rows)


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1, mode: str = "interp",
                  cval: float = 0.0):
    """Savitzky-Golay smoothing (scipy.signal.savgol_filter parity).

    The FIR pass is an FFT convolution on device; 'interp' edges are the
    scipy polynomial edge fit, applied as one host-designed matrix per
    geometry (edge windows are tiny).
    """
    x = _as_host_or_device(x)
    if _iscomplex(x):
        raise ValueError("savgol_filter expects real input")
    if mode not in ("mirror", "constant", "nearest", "interp", "wrap"):
        raise ValueError(f"unknown mode {mode!r}")
    coeffs = savgol_coeffs(window_length, polyorder, deriv=deriv,
                           delta=delta)
    nd = jnp.ndim(x)
    axis = axis % nd
    n = x.shape[axis]
    halflen = window_length // 2
    if mode == "interp":
        if window_length > n:
            raise ValueError("If mode is 'interp', window_length must be "
                             "less than or equal to the size of x.")
        # host-designed f64 edge-fit matrix becomes a trace constant
        E = _savgol_edge_fit(window_length, polyorder, deriv,
                             delta).astype(np.float32)

    def impl(xv):
        # everything device-side in ONE traced program (pad, FIR pass,
        # edge matmuls, edge scatter): one dispatch, not one per eager op
        xm = jnp.moveaxis(xv, axis, -1)
        pads = [(0, 0)] * (xm.ndim - 1) + [(halflen, halflen)]
        if mode == "interp":
            ext = jnp.pad(xm, pads)  # zero-extend; edges replaced below
            y = _fir_same(ext, coeffs)[..., halflen:halflen + n]
            Ej = jnp.asarray(E)
            hi = jax.lax.Precision.HIGHEST  # not TF32: f32 edge fits
            head = jnp.matmul(xm[..., :window_length], Ej[:halflen].T,
                              precision=hi)
            tail = jnp.matmul(xm[..., n - window_length:],
                              Ej[window_length - halflen:].T, precision=hi)
            y = y.at[..., :halflen].set(head)
            y = y.at[..., n - halflen:].set(tail)
        else:
            pad_mode = {"mirror": "reflect", "constant": "constant",
                        "nearest": "edge", "wrap": "wrap"}[mode]
            if mode == "constant":
                ext = jnp.pad(xm, pads, constant_values=cval)
            else:
                ext = jnp.pad(xm, pads, mode=pad_mode)
            y = _fir_same(ext, coeffs)[..., halflen:halflen + n]
        return jnp.moveaxis(y, -1, axis)

    return jax.jit(impl)(jnp.asarray(x, jnp.float32))


def _fir_same(x, taps):
    """'same' FIR pass along the last axis via the device FFT pipeline.
    Size-1 leading dims on the taps broadcast inside fftconvolve's
    spectral multiply (helpers.py), so the kernel FFT is computed ONCE,
    not per batch row."""
    taps = jnp.asarray(np.asarray(taps, np.float32))
    if x.ndim > 1:
        k = taps.reshape((1,) * (x.ndim - 1) + (-1,))
        full = fftconvolve(x, k, axes=(-1,))
    else:
        full = fftconvolve(x, taps)
    lo = (taps.shape[-1] - 1) // 2
    return full[..., lo:lo + x.shape[-1]]


def morlet(M: int, w: float = 5.0, s: float = 1.0, complete: bool = True):
    """Classic Morlet wavelet (scipy.signal.morlet parity), host-side f64
    (a design-time window, like every trig table in this framework)."""
    x = np.linspace(-s * 2 * np.pi, s * 2 * np.pi, M)
    out = np.exp(1j * w * x)
    if complete:
        out = out - np.exp(-0.5 * w ** 2)
    return out * np.exp(-0.5 * x ** 2) * np.pi ** -0.25
