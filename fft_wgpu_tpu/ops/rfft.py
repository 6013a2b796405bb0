"""Real transforms: R2C / C2R through XLA's own real FFT.

New capability vs the reference (which is C2C only — SURVEY §2); required
by BASELINE.json config 4.  Every length, even or odd, runs `jax.lax.fft`
with `FftType.RFFT` / `IRFFT` (cuFFT's R2C/C2R on the GPU), which costs
about half the flops and bytes of a full C2C.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.complex_utils import merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from .nd import _norm_axes

__all__ = ["rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn", "hfft",
           "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn"]


def _scales(n, norm, inverse):
    if norm in (None, "backward"):
        return None if not inverse else 1.0 / n
    if norm == "ortho":
        return n**-0.5
    if norm == "forward":
        return 1.0 / n if not inverse else None
    raise ValueError(f"invalid norm {norm!r}")


def rfft_last_split(xr, scale):
    """R2C over the last axis: real [..., n] -> split pair [..., n//2+1],
    times `scale` (None = unscaled)."""
    n = xr.shape[-1]
    lead = xr.shape[:-1]
    # one batch axis, as in plan.lax_fft (XLA's CPU FFT needs row-major)
    z = lax.fft(xr.astype(jnp.float32).reshape(-1, n), lax.FftType.RFFT,
                (n,)).reshape(lead + (n // 2 + 1,))
    if scale is not None:
        z = z * jnp.float32(scale)
    return jnp.real(z), jnp.imag(z)


def irfft_last_split(Xr, Xi, n, total_scale):
    """C2R over the last axis: split [..., n//2+1] -> real [..., n], with
    explicit TOTAL output scale (numpy's backward norm == 1/n; None = 1).

    C2R semantics (numpy parity): the imaginary parts of the DC bin and,
    for even n, the Nyquist bin are discarded.  They are zeroed here so
    that every backend's C2R sees a Hermitian-consistent input."""
    Xi = Xi.at[..., 0].set(0.0)
    if n % 2 == 0:
        Xi = Xi.at[..., n // 2].set(0.0)
    # lax's IRFFT divides by n; the rest of the total scale goes on top
    net = n * (1.0 if total_scale is None else float(total_scale))
    lead = Xr.shape[:-1]
    x = lax.fft(lax.complex(Xr, Xi).reshape(-1, Xr.shape[-1]),
                lax.FftType.IRFFT, (n,)).reshape(lead + (n,))
    if abs(net - 1.0) > 1e-12:
        x = x * jnp.float32(net)
    return x


def rfft(x, n=None, axis: int = -1, norm=None):
    """1-D R2C FFT: real input -> n//2+1 complex bins (numpy.fft.rfft)."""
    xr = jnp.asarray(x)
    if jnp.iscomplexobj(xr):
        raise TypeError("rfft requires real input; use fft for complex")
    xr = xr.astype(jnp.float32)
    if n is not None and xr.shape[axis] != n:
        xr = _resize_axis(xr, n, axis)
    length = xr.shape[axis]
    scale = _scales(length, norm, inverse=False)

    def impl(v):
        moved = axis not in (-1, v.ndim - 1)
        if moved:
            v = jnp.moveaxis(v, axis, -1)
        Xr, Xi = rfft_last_split(v, scale)
        if moved:
            Xr = jnp.moveaxis(Xr, -1, axis)
            Xi = jnp.moveaxis(Xi, -1, axis)
        return merge(Xr, Xi)

    from ..utils.jit_cache import cached_call, shape_key

    key = ("rfft", jax.default_backend(), shape_key(xr), length, axis,
           scale)
    return cached_call(key, impl, xr)


def irfft(x, n=None, axis: int = -1, norm=None):
    """1-D C2R inverse: n//2+1 bins -> real length-n signal (numpy.fft.irfft)."""
    Xr, Xi = promote_to_split(x)
    length = n if n is not None else 2 * (Xr.shape[axis] - 1)
    bins = length // 2 + 1
    if Xr.shape[axis] != bins:
        Xr = _resize_axis(Xr, bins, axis)
        Xi = _resize_axis(Xi, bins, axis)
    norm_scale = _scales(length, norm, inverse=True)

    def impl(r, i):
        moved = axis not in (-1, r.ndim - 1)
        if moved:
            r = jnp.moveaxis(r, axis, -1)
            i = jnp.moveaxis(i, axis, -1)
        out = irfft_last_split(r, i, length, norm_scale)
        if moved:
            out = jnp.moveaxis(out, -1, axis)
        return out

    from ..utils.jit_cache import cached_call, shape_key

    key = ("irfft", jax.default_backend(), shape_key(Xr), length, axis,
           norm_scale)
    return cached_call(key, impl, Xr, Xi)


def _resize_axis(a, size, axis):
    cur = a.shape[axis]
    if cur > size:
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(0, size)
        return a[tuple(idx)]
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - cur)
    return jnp.pad(a, pad)


def rfftn(x, s=None, axes=None, norm=None):
    """N-D R2C: rfft over the last transform axis, C2C over the rest."""
    xr = jnp.asarray(x).astype(jnp.float32)
    s_, axes_ = _norm_axes(xr.ndim, s, axes)
    last = axes_[-1]
    y = rfft(xr, n=s_[-1], axis=last, norm=norm)
    rest = axes_[:-1]
    if rest:
        from .nd import _run_nd

        y = _run_nd(y, [sz for sz in s_[:-1]], rest, FORWARD, norm, "auto")
    return y


def irfftn(x, s=None, axes=None, norm=None):
    """N-D C2R: inverse C2C over the leading axes, irfft over the last."""
    Xr, Xi = promote_to_split(x)
    z = merge(Xr, Xi)
    s_, axes_ = _norm_axes(Xr.ndim, s, axes)
    rest = axes_[:-1]
    if rest:
        from .nd import _run_nd

        z = _run_nd(z, [sz for sz in s_[:-1]], rest, INVERSE, norm, "auto")
    n_last = s_[-1] if s_[-1] is not None else 2 * (Xr.shape[axes_[-1]] - 1)
    return irfft(z, n=n_last, axis=axes_[-1], norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm=None):
    return rfftn(x, s=s, axes=list(axes), norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm=None):
    return irfftn(x, s=s, axes=list(axes), norm=norm)


def hfft(x, n=None, axis: int = -1, norm=None):
    """FFT of a signal with Hermitian symmetry -> real output
    (numpy.fft.hfft semantics): hfft(x, n) == irfft(conj(x), n) * n."""
    Xr, Xi = promote_to_split(x)
    length = n if n is not None else 2 * (Xr.shape[axis] - 1)
    y = irfft(merge(Xr, -Xi), n=length, axis=axis, norm=None)
    if norm in (None, "backward"):
        return y * jnp.float32(length)
    if norm == "ortho":
        return y * jnp.float32(length**0.5)
    if norm == "forward":
        return y
    raise ValueError(f"invalid norm {norm!r}")


def ihfft(x, n=None, axis: int = -1, norm=None):
    """Inverse of hfft: real input -> half-spectrum with conjugate flip."""
    X = rfft(x, n=n, axis=axis, norm=None)
    length = n if n is not None else jnp.shape(x)[axis]
    Xr, Xi = promote_to_split(X)
    if norm in (None, "backward"):
        s = 1.0 / length
    elif norm == "ortho":
        s = length**-0.5
    elif norm == "forward":
        s = 1.0
    else:
        raise ValueError(f"invalid norm {norm!r}")
    return merge(Xr * jnp.float32(s), -Xi * jnp.float32(s))


# Hermitian N-D transforms (scipy.fft.hfftn/ihfftn): symmetry lives on the
# LAST transform axis only; the rest are ordinary C2C passes.  The whole
# family reduces to the real transforms through the conjugation identity
# hfftn(x, norm) == irfftn(conj(x), norm'), ihfftn(x, norm) ==
# conj(rfftn(x, norm')) with backward <-> forward swapped (the Hermitian
# transforms are normalized as FORWARD transforms while c2r/r2c inverses
# are normalized as inverses).
_NORM_SWAP = {None: "forward", "backward": "forward",
              "forward": "backward", "ortho": "ortho"}


def hfftn(x, s=None, axes=None, norm=None):
    """N-D FFT of a signal Hermitian-symmetric in its last transform axis
    (real spectrum), real output — scipy.fft.hfftn semantics."""
    if norm not in _NORM_SWAP:
        raise ValueError(f"invalid norm {norm!r}")
    Xr, Xi = promote_to_split(x)
    return irfftn(merge(Xr, -Xi), s=s, axes=axes, norm=_NORM_SWAP[norm])


def ihfftn(x, s=None, axes=None, norm=None):
    """Inverse of hfftn: real input -> half-spectrum, conjugate-flipped
    (scipy.fft.ihfftn semantics)."""
    if norm not in _NORM_SWAP:
        raise ValueError(f"invalid norm {norm!r}")
    X = rfftn(x, s=s, axes=axes, norm=_NORM_SWAP[norm])
    Xr, Xi = promote_to_split(X)
    return merge(Xr, -Xi)


def hfft2(x, s=None, axes=(-2, -1), norm=None):
    return hfftn(x, s=s, axes=None if axes is None else list(axes), norm=norm)


def ihfft2(x, s=None, axes=(-2, -1), norm=None):
    return ihfftn(x, s=s, axes=None if axes is None else list(axes), norm=norm)
