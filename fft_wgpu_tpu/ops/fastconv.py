"""Spectral filtering: ``y = ifft(fft(x) * H)`` as one jitted program.

This is the fast-convolution serving loop (FIR filtering, channel
equalization, deconvolution): a forward transform, the spectrum multiply
and an inverse transform, all through the plan layer's "auto" route, which
XLA fuses and schedules as one program.

The reference has no analogue (fft_wgpu is a bare FFT); this is the
framework's production filtering path.  Host inputs are split at the
boundary; `SpectralFilter` stores the response planar.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge, promote_to_split

__all__ = ["SpectralFilter", "spectral_filter"]


class SpectralFilter:
    """Plan-style fused circular filter: build once per (n, response),
    replay on any row batch.

    Parameters
    ----------
    h : array
        Filter, length n.  ``domain='freq'`` (default) = the complex
        frequency response H[k]; ``domain='time'`` = the (possibly
        complex) circular impulse response, transformed once at build.
    n : int, optional
        Transform length (defaults to ``len(h)``).

    ``apply(x)`` computes ``ifft(fft(x) * H)`` along the last axis of x
    (circular convolution with the impulse response) as one jitted
    program.
    """

    def __init__(self, h, n: int | None = None, *, domain: str = "freq"):
        h = np.asarray(h)
        self.n = int(n if n is not None else h.shape[-1])
        if h.shape[-1] != self.n:
            raise ValueError(f"filter length {h.shape[-1]} != n={self.n}")
        if h.ndim != 1:
            raise ValueError("h must be 1-D")
        if domain == "time":
            H = np.fft.fft(h.astype(np.complex128))
        elif domain == "freq":
            H = h.astype(np.complex128)
        else:
            raise ValueError(f"domain must be 'freq' or 'time', got {domain!r}")
        # f64-generated, cast once (trig-table discipline applies to
        # responses too: they are constants of the compiled program)
        self._hr = jnp.asarray(np.ascontiguousarray(H.real, np.float32))
        self._hi = jnp.asarray(np.ascontiguousarray(H.imag, np.float32))
        self._jit = None

    def _build(self):
        from ..plan.plan import get_plan

        p = get_plan(self.n)
        inv_n = 1.0 / self.n

        def impl(re, im, hr, hi):
            Xr, Xi = p._execute_split(re, im, -1, None)
            cr = Xr * hr - Xi * hi
            ci = Xr * hi + Xi * hr
            return p._execute_split(cr, ci, +1, inv_n)

        return jax.jit(impl)

    def apply(self, x):
        """Filter x (host numpy or device array, [..., n]) -> complex
        device array of the same shape."""
        re, im = promote_to_split(x)
        if re.shape[-1] != self.n:
            raise ValueError(
                f"last axis {re.shape[-1]} != plan length {self.n}")
        if self._jit is None:
            self._jit = self._build()
        yr, yi = self._jit(re, im, self._hr, self._hi)
        return merge(yr, yi)

    __call__ = apply


def spectral_filter(x, h, *, domain: str = "freq"):
    """One-shot fused circular filter ``ifft(fft(x) * H)`` along the
    last axis.  Builds a throwaway :class:`SpectralFilter`; for replay
    loops construct the plan once and call it."""
    return SpectralFilter(h, domain=domain).apply(x)
