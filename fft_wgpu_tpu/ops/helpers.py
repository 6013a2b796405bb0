"""numpy.fft-compatible helpers: shifts, frequency grids, FFT convolution.

Completeness layer so reference users migrating from any FFT stack find
the full expected surface (SURVEY §7 contract: everything composable
under one jit).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "next_fast_len",
    "prev_fast_len",
    "get_workers",
    "set_workers",
    "fftconvolve",
    "convolve",
    "correlate",
    "choose_conv_method",
    "fftcorrelate",
    "hilbert",
    "hilbert2",
    "resample",
    "fftshift",
    "ifftshift",
    "fftfreq",
    "rfftfreq",
    "fft_convolve",
    "correlation_lags",
    "detrend",
    "oaconvolve",
    "dht",
    "idht",
]


def fftshift(x, axes=None):
    """Shift zero-frequency to center (numpy.fft.fftshift)."""
    x = jnp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    return jnp.roll(x, [x.shape[a] // 2 for a in axes], axes)


def ifftshift(x, axes=None):
    """Inverse of fftshift."""
    x = jnp.asarray(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    return jnp.roll(x, [-(x.shape[a] // 2) for a in axes], axes)


def fftfreq(n: int, d: float = 1.0, *, dtype=jnp.float32):
    """Sample frequencies for fft output bins (numpy.fft.fftfreq)."""
    k = np.fft.fftfreq(n, d).astype(np.float32)  # host-side, exact semantics
    return jnp.asarray(k, dtype)


def rfftfreq(n: int, d: float = 1.0, *, dtype=jnp.float32):
    """Sample frequencies for rfft output bins (numpy.fft.rfftfreq)."""
    k = np.fft.rfftfreq(n, d).astype(np.float32)
    return jnp.asarray(k, dtype)


def _as_host_or_device(x):
    """Normalize input to something with .shape WITHOUT complex transfers:
    python sequences become host numpy; numpy/jnp arrays pass through."""
    if not hasattr(x, "shape"):
        return np.asarray(x)
    return x


def _iscomplex(x) -> bool:
    # np.iscomplexobj on a host array avoids touching the device; jnp
    # arrays are already resident so dtype inspection is free.
    if isinstance(x, np.ndarray):
        return np.iscomplexobj(x)
    return jnp.iscomplexobj(x)


def fft_convolve(a, b, mode: str = "full", axis: int = -1):
    """1-D linear convolution via the FFT (scipy.signal.fftconvolve-style).

    Real inputs use the R2C pipeline.  Complex host inputs are split at
    the boundary inside `fft` (no complex H2D transfer — CLAUDE.md rule).
    """
    from .rfft import irfft, rfft
    from .transforms import fft, ifft

    a = _as_host_or_device(a)
    b = _as_host_or_device(b)
    la = a.shape[axis]
    lb = b.shape[axis]
    lfull = la + lb - 1
    nfft = 1 << max(1, math.ceil(math.log2(lfull)))

    if _iscomplex(a) or _iscomplex(b):
        fa = fft(a, n=nfft, axis=axis)
        fb = fft(b, n=nfft, axis=axis)
        full = ifft(fa * fb, axis=axis)
    else:
        fa = rfft(jnp.asarray(a, jnp.float32), n=nfft, axis=axis)
        fb = rfft(jnp.asarray(b, jnp.float32), n=nfft, axis=axis)
        full = irfft(fa * fb, n=nfft, axis=axis)

    sl = [slice(None)] * full.ndim
    if mode == "full":
        sl[axis] = slice(0, lfull)
    elif mode == "same":
        start = (lb - 1) // 2
        sl[axis] = slice(start, start + la)
    elif mode == "valid":
        lv = max(la, lb) - min(la, lb) + 1
        start = min(la, lb) - 1
        sl[axis] = slice(start, start + lv)
    else:
        raise ValueError(f"invalid mode {mode!r}")
    return full[tuple(sl)]


def oaconvolve(a, b, mode: str = "full", axes=None, axis: int = None):
    """Overlap-add convolution for a long signal `a` with a short kernel
    `b` (scipy.signal.oaconvolve semantics).

    The overlap-add fast path runs along ONE axis (scipy's axes= with a
    single entry, or the legacy axis= spelling): the signal is
    segmented, all segments are transformed in ONE batched R2C call
    (the framework's sweet spot), multiplied by the kernel spectrum,
    inverse-transformed, and overlap-added.  scipy's default
    (axes=None: convolve over every axis) and multi-axis requests
    delegate to fftconvolve for N-D inputs — same result, no
    segmentation.
    """
    from ..core.complex_utils import promote_to_split
    from .rfft import irfft, rfft
    from .transforms import fft as cfft, ifft as cifft

    a = _as_host_or_device(a)
    b = _as_host_or_device(b)
    if axis is None:
        if axes is None:
            if max(np.ndim(a), np.ndim(b)) > 1:
                return fftconvolve(a, b, mode=mode)
            axis = -1
        else:
            ax_list = [axes] if np.isscalar(axes) else list(axes)
            if len(ax_list) != 1:
                return fftconvolve(a, b, mode=mode, axes=ax_list)
            axis = int(ax_list[0])
    la0 = a.shape[axis]
    lb0 = b.shape[axis]
    # Swap only for the segmentation math (convolution is commutative);
    # the mode slicing at the end uses the ORIGINAL la0/lb0 so 'same'
    # follows the first argument like scipy's oaconvolve.
    if la0 < lb0:
        a, b = b, a
    la, lb = max(la0, lb0), min(la0, lb0)
    lfull = la + lb - 1

    # segment size: a few kernel lengths, power-of-two FFT
    nfft = 1 << max(3, math.ceil(math.log2(8 * lb)))
    step = nfft - (lb - 1)
    nseg = -(-la // step)

    cplx = _iscomplex(a) or _iscomplex(b)
    Ff = (cfft if cplx else rfft)
    Fi = (lambda z, n, ax: cifft(z, axis=ax)) if cplx else (
        lambda z, n, ax: irfft(z, n=n, axis=ax)
    )

    def impl(*ops):
        # complex operands arrive as split (re, im) pairs — merged here,
        # inside jit, so no complex array ever crosses host<->device.
        if cplx:
            av = jax.lax.complex(ops[0], ops[1])
            bv = jax.lax.complex(ops[2], ops[3])
        else:
            av, bv = ops
        x = jnp.moveaxis(av, axis, -1)
        lead = x.shape[:-1]
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nseg * step - la)]
        xp = jnp.pad(x, pad).reshape(*lead, nseg, step)
        segs = jnp.pad(xp, [(0, 0)] * (x.ndim - 1) + [(0, 0), (0, nfft - step)])
        B = Ff(jnp.moveaxis(bv, axis, -1), n=nfft, axis=-1)
        if B.ndim > 1:
            B = B[..., None, :]  # broadcast over the segment axis
        S = Ff(segs, axis=-1)
        Y = Fi(S * B, nfft, -1)  # [.., nseg, nfft]
        # overlap-add into [.., nseg*step + nfft - step] — SCATTER-FREE:
        # pad each frame to K*step and accumulate K contiguous shifted
        # slabs (the istft trick generalized to step !| nfft), in place of
        # a flat-index .at[idx].add scatter.
        t = nseg * step + (nfft - step)
        K = -(-nfft // step)
        Yp = jnp.pad(Y, [(0, 0)] * (Y.ndim - 1) + [(0, K * step - nfft)])
        ch = Yp.reshape(*lead, nseg, K, step)
        out = jnp.zeros((*lead, nseg + K - 1, step), Y.dtype)
        for k in range(K):
            out = out.at[..., k : k + nseg, :].add(ch[..., :, k, :])
        out = out.reshape(*lead, (nseg + K - 1) * step)[..., :t]
        return jnp.moveaxis(out[..., :lfull], -1, axis)

    from ..utils.jit_cache import cached_call, shape_key

    key = ("oaconv", jax.default_backend(), shape_key(a), shape_key(b),
           str(getattr(a, "dtype", "f32")), str(getattr(b, "dtype", "f32")),
           axis, cplx, nfft, step)
    if cplx:
        ar, ai = promote_to_split(a)
        br, bi = promote_to_split(b)
        full = cached_call(key, impl, ar, ai, br, bi)
    else:
        full = cached_call(key, impl, jnp.asarray(a, jnp.float32),
                           jnp.asarray(b, jnp.float32))

    sl = [slice(None)] * full.ndim
    if mode == "full":
        return full
    if mode == "same":
        # scipy semantics: 'same' is relative to the FIRST input as the
        # user passed it, independent of the internal segmentation swap.
        start = (lb0 - 1) // 2
        sl[axis] = slice(start, start + la0)
    elif mode == "valid":
        lv = la - lb + 1
        sl[axis] = slice(lb - 1, lb - 1 + lv)
    else:
        raise ValueError(f"invalid mode {mode!r}")
    return full[tuple(sl)]


def next_fast_len(target: int, real: bool = False) -> int:
    """Smallest 5-smooth n >= target (scipy.fft.next_fast_len semantics).

    With `real=True` the result is additionally forced EVEN (scipy's
    preference for real transforms).
    """
    if target <= 1:
        return 2 if real else 1
    best = 1 << (target - 1).bit_length()  # pow2 upper bound (even)
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            # smallest power of two lifting p35 over target (even if real)
            q = p35
            while q < target or (real and q % 2):
                q *= 2
            if q < best:
                best = q
            p35 *= 3
        p5 *= 5
    return best


def prev_fast_len(target: int, real: bool = False) -> int:
    """Largest 5-smooth n <= target (scipy.fft.prev_fast_len semantics);
    with `real=True` additionally even (matching next_fast_len's packed
    even-n fast-path preference) — except target=1, where no even value
    <= target exists and 1 is returned (scipy behavior).  target >= 1."""
    if target < 1:
        raise ValueError("target must be a positive integer")
    best = 1
    p5 = 1
    while p5 <= target:
        p35 = p5
        while p35 <= target:
            q = p35  # largest 2^a * p35 <= target
            while q * 2 <= target:
                q *= 2
            if q > best and not (real and q % 2):
                best = q
            p35 *= 3
        p5 *= 5
    return best


# scipy.fft worker-count shims: each transform is one XLA program on the
# device (parallelism comes from the device, not host threads), so the
# worker count is advisory-only for API parity.
_workers = 1


def get_workers() -> int:
    """scipy.fft.get_workers parity (advisory; see set_workers)."""
    return _workers


class set_workers:
    """scipy.fft.set_workers parity: a context manager recording the
    requested worker count.  No-op on execution — XLA owns parallelism —
    but accepted so scipy.fft call sites port unchanged."""

    def __init__(self, workers: int):
        self.workers = int(workers)
        self._prev = None

    def __enter__(self):
        global _workers
        self._prev, _workers = _workers, self.workers
        return self

    def __exit__(self, *exc):
        global _workers
        _workers = self._prev
        return False


def fftconvolve(a, b, mode: str = "full", axes=None):
    """N-D linear convolution via FFTs (scipy.signal.fftconvolve).

    `axes=None` convolves over all axes (shapes must match on the rest);
    real inputs ride the R2C pipeline on the last convolved axis and C2C
    elsewhere; each transform length pads to the next fast (5-smooth,
    even) size.
    """
    from ..core.complex_utils import merge, promote_to_split
    from .nd import fftn, ifftn

    a = _as_host_or_device(a)
    b = _as_host_or_device(b)
    if jnp.ndim(a) != jnp.ndim(b):
        raise ValueError("fftconvolve inputs must have equal rank")
    nd = jnp.ndim(a)
    if axes is None:
        axes = tuple(range(nd))
    elif np.isscalar(axes):
        axes = (int(axes),)
    axes = tuple(ax % nd for ax in axes)
    for ax in range(nd):
        if (ax not in axes and a.shape[ax] != b.shape[ax]
                and 1 not in (a.shape[ax], b.shape[ax])):
            raise ValueError(  # scipy broadcasts size-1 non-convolved axes
                f"non-convolved axis {ax} must match or be broadcastable: "
                f"{a.shape} vs {b.shape}")
    if mode == "valid" and not (
        all(a.shape[ax] >= b.shape[ax] for ax in axes)
        or all(b.shape[ax] >= a.shape[ax] for ax in axes)
    ):
        raise ValueError(
            "for mode='valid' one input must be at least as large as the "
            "other in every convolved dimension")  # scipy parity
    lfull = [a.shape[ax] + b.shape[ax] - 1 for ax in axes]
    shape = [next_fast_len(l, real=True) for l in lfull]

    sl = [slice(None)] * nd
    for ax, lf in zip(axes, lfull):
        la, lb = a.shape[ax], b.shape[ax]
        if mode == "full":
            sl[ax] = slice(0, lf)
        elif mode == "same":
            start = (lb - 1) // 2
            sl[ax] = slice(start, start + la)
        elif mode == "valid":
            lv = max(la, lb) - min(la, lb) + 1
            start = min(la, lb) - 1
            sl[ax] = slice(start, start + lv)
        else:
            raise ValueError(f"invalid mode {mode!r}")
    sl = tuple(sl)

    # the whole pipeline traces into ONE jitted program (CLAUDE.md rule);
    # complex hosts are split OUTSIDE it (no complex H2D) and re-merged
    # under trace
    if _iscomplex(a) or _iscomplex(b):
        ar, ai = promote_to_split(a)
        br_, bi_ = promote_to_split(b)

        def impl(ar, ai, br_, bi_):
            fa = fftn(merge(ar, ai), s=shape, axes=axes)
            fb = fftn(merge(br_, bi_), s=shape, axes=axes)
            return ifftn(fa * fb, axes=axes)[sl]

        from ..utils.jit_cache import cached_call, shape_key

        key = ("fftconv_c", jax.default_backend(), shape_key(ar),
               shape_key(br_), tuple(shape), tuple(axes), str(sl))
        return cached_call(key, impl, ar, ai, br_, bi_)

    # Real path: R2C over the last convolved axis, C2C over the rest,
    # spectrum product, then the inverses in reverse order.
    from ..core.twiddle import FORWARD, INVERSE
    from .nd import fftn_split
    from .rfft import irfft_last_split, rfft_last_split

    last = axes[-1]
    rest = axes[:-1]
    n_last = shape[-1]

    def _pad_to(v):
        pads = [(0, 0)] * nd
        for ax, L in zip(axes, shape):
            pads[ax] = (0, L - v.shape[ax])
        return jnp.pad(v, pads)

    def _rfwd(v):
        moved = last != nd - 1
        if moved:
            v = jnp.moveaxis(v, last, -1)
        Xr, Xi = rfft_last_split(v, None)
        if moved:
            Xr = jnp.moveaxis(Xr, -1, last)
            Xi = jnp.moveaxis(Xi, -1, last)
        if rest:
            Xr, Xi = fftn_split(Xr, Xi, rest, FORWARD, None)
        return Xr, Xi

    def impl(av, bv):
        far, fai = _rfwd(_pad_to(av))
        fbr, fbi = _rfwd(_pad_to(bv))
        moved = last != nd - 1
        pr = far * fbr - fai * fbi
        pi = far * fbi + fai * fbr
        if rest:
            inv_scale = 1.0
            for ax in rest:
                inv_scale /= shape[axes.index(ax)]
            pr, pi = fftn_split(pr, pi, rest, INVERSE, inv_scale)
        if moved:
            pr = jnp.moveaxis(pr, last, -1)
            pi = jnp.moveaxis(pi, last, -1)
        out = irfft_last_split(pr, pi, n_last, 1.0 / n_last)
        if moved:
            out = jnp.moveaxis(out, -1, last)
        return out[sl]

    from ..utils.jit_cache import cached_call, shape_key

    key = ("fftconv_r", jax.default_backend(), shape_key(a), shape_key(b),
           tuple(shape), tuple(axes), str(sl))
    return cached_call(key, impl, jnp.asarray(a, jnp.float32),
                       jnp.asarray(b, jnp.float32))


def fftcorrelate(a, b, mode: str = "full", axes=None):
    """N-D cross-correlation via FFTs (scipy.signal.correlate with
    method='fft'): correlate(a, b) == fftconvolve(a, conj(b reversed))."""
    b = _as_host_or_device(b)
    if axes is not None and np.isscalar(axes):
        axes = (int(axes),)
    if axes is None:
        rev = tuple(slice(None, None, -1) for _ in range(jnp.ndim(b)))
    else:
        nd = jnp.ndim(b)
        axset = {ax % nd for ax in axes}
        rev = tuple(slice(None, None, -1) if ax in axset else slice(None)
                    for ax in range(nd))
    if _iscomplex(b):
        if isinstance(b, np.ndarray):
            # host complex stays on the host (no complex H2D — CLAUDE.md);
            # fftconvolve splits it at its own boundary
            br = np.conj(b[rev])
        else:
            br = jnp.conj(b[rev])  # already device-resident
    else:
        br = b[rev]
    return fftconvolve(a, br, mode=mode, axes=axes)


def hilbert(x, n: int = None, axis: int = -1, *, N: int = None):
    """Analytic signal via the FFT (scipy.signal.hilbert): real input ->
    complex x + i*H(x) — one jitted program; the spectrum weighting
    h = [1, 2, .., 2, (1), 0, ..] zeroes negative frequencies.  scipy
    spells the length argument N=; both are accepted."""
    from ..core.complex_utils import merge
    from ..plan.plan import get_plan

    if N is not None:
        if n is not None and n != N:
            raise ValueError("pass only one of n= and N=")
        n = N
    x0 = _as_host_or_device(x)
    if _iscomplex(x0):  # checked BEFORE any device transfer
        raise ValueError("hilbert requires a real input")
    length = n if n is not None else x0.shape[axis]

    h = np.zeros(length, np.float32)
    if length % 2 == 0:
        h[0] = h[length // 2] = 1.0
        h[1 : length // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (length + 1) // 2] = 2.0
    p = get_plan(length)

    def impl(v):
        v = jnp.moveaxis(v, axis, -1)
        if v.shape[-1] != length:
            from .rfft import _resize_axis

            v = _resize_axis(v, length, -1)
        re, im = p._execute_split(v, jnp.zeros_like(v), -1, None)
        hh = jnp.asarray(h)
        re, im = p._execute_split(re * hh, im * hh, +1, 1.0 / length)
        return merge(jnp.moveaxis(re, -1, axis), jnp.moveaxis(im, -1, axis))

    from ..utils.jit_cache import cached_call, shape_key

    key = ("hilbert", jax.default_backend(), shape_key(x0), length, axis)
    return cached_call(key, impl, jnp.asarray(x0, jnp.float32))


def _resample_window(window, n):
    """Host-side spectral window for `resample` (scipy semantics):
    callable -> window(fftfreq(n)); array -> used as-is (fft bin order);
    name/tuple -> fftshift(get_window(window, n)).  f64 numpy out."""
    if callable(window):
        W = np.asarray(window(np.fft.fftfreq(n)))
    elif hasattr(window, "shape") or isinstance(window, (list,)):
        W = np.asarray(window)
        if W.shape != (n,):
            raise ValueError(f"window length {W.shape} != number of "
                             f"frequency bins ({n},)")
    else:
        from .spectral_est import get_window

        W = np.fft.fftshift(np.asarray(get_window(window, n), np.float64))
    if np.iscomplexobj(W):
        raise ValueError("complex spectral windows are not supported")
    return W.astype(np.float64)


def resample(x, num: int, t=None, axis: int = 0, window=None,
             domain: str = "time"):
    """FFT-domain resampling (scipy.signal.resample parity): transform,
    truncate or zero-pad the spectrum to `num` bins, inverse transform,
    rescale by num/n — one jitted split-domain program.  Real input rides
    the half-spectrum path; complex input and `domain='freq'` run the
    two-sided form.  `window` is applied in the frequency domain (folded
    onto the half spectrum for real input, scipy eq.); with `t` the
    resampled sample positions are returned as a second value."""
    from .rfft import irfft_last_split, rfft_last_split

    if domain not in ("time", "freq"):
        raise ValueError(f"domain must be 'time' or 'freq', got {domain!r}")
    num = int(num)
    if num < 1:
        raise ValueError("num must be >= 1")
    x0 = _as_host_or_device(x)
    n = x0.shape[axis]
    m = min(num, n)
    m2 = m // 2 + 1
    s_fac = n / num
    W = None if window is None else _resample_window(window, n)

    if domain == "time" and not _iscomplex(x0):
        old_bins = n // 2 + 1
        if W is not None:
            # fold the two-sided window onto the half spectrum:
            # W1[l] = (W[l] + W[n-l]) / 2 for 0 < l < old_bins
            Wf = W[:old_bins].copy()
            Wf[1:] = (W[1:old_bins] + W[:-old_bins:-1]) / 2.0
            Wf = Wf.astype(np.float32)

        def impl(v):
            v = jnp.moveaxis(v, axis, -1)
            Xr, Xi = rfft_last_split(v, None)
            if W is not None:
                wj = jnp.asarray(Wf)
                Xr, Xi = Xr * wj, Xi * wj
            if m2 <= old_bins:
                Xr = Xr[..., :m2]
                Xi = Xi[..., :m2]
                if num % 2 == 0 and num < n:
                    # the kept +num/2 and -num/2 bins fold into the new
                    # (real) Nyquist: X[num/2] + conj(.) = 2*Re(X[num/2])
                    Xr = Xr.at[..., -1].mul(2.0)
                    Xi = Xi.at[..., -1].mul(0.0)
            if m2 > old_bins or num > n:
                if n % 2 == 0:
                    # old Nyquist splits across +/- frequencies: halve it
                    Xr = Xr.at[..., old_bins - 1].mul(0.5)
                    Xi = Xi.at[..., old_bins - 1].mul(0.5)
                new_bins = num // 2 + 1
                if new_bins > Xr.shape[-1]:
                    pad = ([(0, 0)] * (Xr.ndim - 1)
                           + [(0, new_bins - Xr.shape[-1])])
                    Xr = jnp.pad(Xr, pad)
                    Xi = jnp.pad(Xi, pad)
            # total scale num/n with the inverse's 1/num folded in => 1/n
            y = irfft_last_split(Xr, Xi, num, 1.0 / n)
            return jnp.moveaxis(y, -1, axis)

        out = jax.jit(impl)(jnp.asarray(x0, jnp.float32))
    else:  # complex input or spectrum input: two-sided form
        from ..core.complex_utils import merge, split
        from .nd import fftn_split

        vr, vi = split(x0)  # host complex split on the host (CLAUDE.md)

        def impl(vr, vi):
            vr = jnp.moveaxis(vr, axis, -1)
            vi = jnp.moveaxis(vi, axis, -1)
            if domain == "time":
                Xr, Xi = fftn_split(vr, vi, (vr.ndim - 1,), -1, None)
            else:
                Xr, Xi = vr, vi
            if W is not None:
                wj = jnp.asarray(W.astype(np.float32))
                Xr, Xi = Xr * wj, Xi * wj
            shp = Xr.shape[:-1] + (num,)
            Yr = jnp.zeros(shp, Xr.dtype).at[..., :m2].set(Xr[..., :m2])
            Yi = jnp.zeros(shp, Xi.dtype).at[..., :m2].set(Xi[..., :m2])
            if m2 < m:  # negative-frequency half
                Yr = Yr.at[..., m2 - m:].set(Xr[..., m2 - m:])
                Yi = Yi.at[..., m2 - m:].set(Xi[..., m2 - m:])
            if m % 2 == 0:
                if num < n:  # down: unite the bin pair at -m/2
                    Yr = Yr.at[..., -m // 2].add(Xr[..., -m // 2])
                    Yi = Yi.at[..., -m // 2].add(Xi[..., -m // 2])
                elif n < num:  # up: split the unpaired bin at m/2
                    Yr = Yr.at[..., m // 2].mul(0.5)
                    Yi = Yi.at[..., m // 2].mul(0.5)
                    Yr = Yr.at[..., num - m // 2].set(Yr[..., m // 2])
                    Yi = Yi.at[..., num - m // 2].set(Yi[..., m // 2])
            # ifft(Y / s_fac): 1/num inverse scale * num/n => 1/n
            yr, yi = fftn_split(Yr, Yi, (Yr.ndim - 1,), 1, 1.0 / n)
            return (jnp.moveaxis(yr, -1, axis),
                    jnp.moveaxis(yi, -1, axis))

        out = merge(*jax.jit(impl)(vr, vi))
    if t is not None:
        t = np.asarray(t)
        return out, t[0] + (t[1] - t[0]) * s_fac * np.arange(num)
    return out


def hilbert2(x, N=None):
    """2-D analytic signal (scipy.signal.hilbert2): real [.., n1, n2] ->
    complex with the first-quadrant spectrum kept x4 (h1 (x) h2 outer
    weighting over the last two axes), one jitted program.  `N` resizes
    the transform lengths (scalar or per-axis pair), scipy-named."""
    from ..core.complex_utils import merge
    from .nd import fftn_split

    x0 = _as_host_or_device(x)
    if _iscomplex(x0):
        raise ValueError("hilbert2 requires a real input")
    if x0.ndim < 2:
        raise ValueError("hilbert2 requires at least 2 dimensions")
    if N is not None:
        n1, n2 = (N, N) if np.isscalar(N) else N
        if n1 <= 0 or n2 <= 0:
            raise ValueError("N must be positive")
    else:
        n1, n2 = x0.shape[-2], x0.shape[-1]

    def h(length):
        # scipy's 2-D mask differs from 1-D hilbert: the Nyquist row/col
        # is ZEROED for even lengths (Xf[k0:] = 0 with k0 = (N+1)//2)
        v = np.zeros(length, np.float32)
        v[0] = 1.0
        v[1: (length + 1) // 2] = 2.0
        return v

    hh = np.outer(h(n1), h(n2))

    def impl(v):
        from .rfft import _resize_axis

        if v.shape[-2] != n1:
            v = _resize_axis(v, n1, -2)
        if v.shape[-1] != n2:
            v = _resize_axis(v, n2, -1)
        re, im = fftn_split(v, jnp.zeros_like(v), (v.ndim - 2, v.ndim - 1),
                            -1, None)
        w = jnp.asarray(hh)
        re, im = fftn_split(re * w, im * w, (v.ndim - 2, v.ndim - 1), 1,
                            1.0 / (n1 * n2))
        return merge(re, im)

    return jax.jit(impl)(jnp.asarray(x0, jnp.float32))


@functools.partial(jax.jit, static_argnames=("axis", "inverse"))
def _dht_impl(v, *, axis, inverse):
    from ..core.twiddle import FORWARD
    from .nd import fftn_split
    from .rfft import rfft_last_split

    v = jnp.moveaxis(v, axis, -1)
    n = v.shape[-1]
    if n % 2 == 0:
        Xr, Xi = rfft_last_split(v, None)
        # Hermitian extension: H[k] = Re X[k] - Im X[k] with
        # X[n-k] = conj(X[k]) -> Re mirror, -Im mirror
        Hr = Xr - Xi
        tailr = Xr[..., 1:-1][..., ::-1]
        taili = Xi[..., 1:-1][..., ::-1]
        H = jnp.concatenate([Hr, tailr + taili], axis=-1)
    else:
        Xr, Xi = fftn_split(v, jnp.zeros_like(v), (v.ndim - 1,),
                            FORWARD, None)
        H = Xr - Xi
    if inverse:
        H = H * (1.0 / n)
    return jnp.moveaxis(H, -1, axis)


def _check_real_f32(x, what):
    if np.iscomplexobj(x) if isinstance(x, np.ndarray) else jnp.iscomplexobj(
            jnp.asarray(x) if not hasattr(x, "dtype") else x):
        raise ValueError(f"{what} requires real input")
    return jnp.asarray(x, jnp.float32)


def dht(x, axis: int = -1):
    """Discrete Hartley transform along `axis`:
    H[k] = sum_j x[j] (cos(2 pi j k / n) + sin(2 pi j k / n)).

    Real-to-real, self-inverse up to 1/n (idht).  Evaluated as
    Re(FFT) - Im(FFT) on the R2C path — one module-level jitted program
    per (shape, axis)."""
    return _dht_impl(_check_real_f32(x, "dht"), axis=axis, inverse=False)


def idht(x, axis: int = -1):
    """Inverse discrete Hartley transform: idht(dht(x)) == x (the DHT is
    self-inverse up to the 1/n factor, folded into the jitted program)."""
    return _dht_impl(_check_real_f32(x, "idht"), axis=axis, inverse=True)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full"):
    """Lag indices for :func:`fftcorrelate` output (scipy.signal
    .correlation_lags parity; host index math)."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lag_bound = in1_len // 2
        return lags[mid - lag_bound:mid + lag_bound + (in1_len % 2)]
    if mode == "valid":
        lag_bound = in1_len - in2_len
        if lag_bound >= 0:
            return np.arange(lag_bound + 1)
        return np.arange(lag_bound, 1)
    raise ValueError(f"invalid mode {mode!r}")


@functools.partial(jax.jit, static_argnums=(1, 2))
def _detrend_linear(v, N, bp):
    # v: [N, rest] — remove a per-segment least-squares line (normal
    # equations in closed 2x2 form: A = [t/Npts, 1] is perfectly
    # conditioned at these scales)
    out = v
    for m in range(len(bp) - 1):
        npts = int(bp[m + 1] - bp[m])
        t = jnp.arange(1, npts + 1, dtype=v.dtype) / npts
        seg = out[bp[m]:bp[m + 1]]
        st = jnp.sum(t)
        stt = jnp.sum(t * t)
        sy = jnp.sum(seg, 0)
        sty = jnp.sum(t[:, None] * seg, 0)
        det = npts * stt - st * st
        a = (npts * sty - st * sy) / det       # slope coefficient
        b = (stt * sy - st * sty) / det        # intercept
        out = out.at[bp[m]:bp[m + 1]].set(seg - (t[:, None] * a + b))
    return out


def detrend(data, axis: int = -1, type: str = "linear", bp=0):
    """Remove a constant or piecewise-linear trend (scipy.signal.detrend
    parity).  `bp` gives breakpoints along `axis` for piecewise fits.

    Complex input detrends re/im independently (least squares decomposes
    componentwise), split at the host boundary per CLAUDE.md."""
    data = _as_host_or_device(data)
    if _iscomplex(data):
        from ..core.complex_utils import merge, split
        re, im = split(data)
        return merge(detrend(re, axis, type, bp), detrend(im, axis, type, bp))
    if type in ("constant", "c"):
        x = jnp.asarray(data, jnp.float32)
        return x - jnp.mean(x, axis=axis, keepdims=True)
    if type not in ("linear", "l"):
        raise ValueError("trend type must be 'linear' or 'constant'")
    x = jnp.asarray(data, jnp.float32)
    N = x.shape[axis]
    bps = np.sort(np.unique(np.concatenate([[0], np.atleast_1d(bp), [N]])))
    if np.any(bps > N) or np.any(bps < 0):
        raise ValueError("breakpoints must lie within the axis length")
    ax = axis % x.ndim
    moved_shape = (N, *(s for i, s in enumerate(x.shape) if i != ax))
    v = jnp.moveaxis(x, ax, 0).reshape(N, -1)
    out = _detrend_linear(v, N, tuple(int(b) for b in bps))
    return jnp.moveaxis(out.reshape(moved_shape), 0, ax)


def choose_conv_method(in1, in2, mode: str = "full", measure: bool = False):
    """scipy.signal.choose_conv_method parity shim: on this framework the
    FFT path IS the implementation (batched transforms, not sliding
    windows), so the answer is always 'fft'.  With measure=True
    returns ('fft', {}) like scipy's two-tuple form."""
    return ("fft", {}) if measure else "fft"


def convolve(in1, in2, mode: str = "full", method: str = "auto"):
    """N-D convolution (scipy.signal.convolve drop-in).  `method` accepts
    'auto'/'fft'/'direct'; all routes run the FFT implementation
    (:func:`fftconvolve`), which matches the direct sum to ~1e-6 in f32."""
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"invalid method {method!r}")
    return fftconvolve(in1, in2, mode=mode)


def correlate(in1, in2, mode: str = "full", method: str = "auto"):
    """N-D correlation (scipy.signal.correlate drop-in) on the FFT path
    (:func:`fftcorrelate`)."""
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"invalid method {method!r}")
    return fftcorrelate(in1, in2, mode=mode)
