"""Discrete cosine / sine transforms (scipy.fft-compatible types I-IV).

Built on the C2C pipeline via permutation/extension tricks, so the hot
loop is always the library's FFT:

    DCT-I:   Re(FFT(even-symmetric extension, length 2(n-1)))[:n]
    DCT-II:  v[j] = x[2j], v[n-1-j] = x[2j+1];  V = FFT(v)
             X[k] = 2 * Re( exp(-i*pi*k/(2n)) * V[k] )
    DCT-III: inverse of II (with matching norm conventions)
    DCT-IV:  modulated FFT of the signed even-odd permutation (see _dct4)
    DST-I:   -Im(FFT(odd-symmetric extension, length 2(n+1)))[1:n+1]
    DST-II/III: via DCT of the sign-flipped, reversed sequence
    DST-IV:  (-1)^k * DCT-IV(reversed input)
"""

from __future__ import annotations

import functools

from ..utils.jit_cache import cached_call as _cc
from ..utils.jit_cache import shape_key as _sk
import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import promote_to_split

__all__ = ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn"]


@functools.lru_cache(maxsize=None)
def _halfshift_np(n: int, sign: int):
    k = np.arange(n, dtype=np.float64)
    theta = sign * np.pi * k / (2.0 * n)
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


def _even_odd_perm(n: int) -> np.ndarray:
    """v = x[perm]: the evens ascending, then the odds descending."""
    evens = np.arange(0, n, 2)
    odds = np.arange(1, n, 2)[::-1]
    return np.concatenate([evens, odds]).astype(np.int32)


def _norm_opt(norm):
    """scipy norm strings: None == 'backward'; 'ortho' and 'forward'
    pass through; anything else is rejected."""
    if norm in (None, "backward"):
        return None
    if norm in ("ortho", "forward"):
        return norm
    raise ValueError(f"invalid norm {norm!r} "
                     "(expected 'backward', 'ortho', or 'forward')")


def _roundtrip_factor(type, n):
    """The unnormalized DCT/DST round-trip scale: 2(n-1) for DCT-I,
    2(n+1) for DST-I, 2n otherwise."""
    return 2 * (n - 1) if type == 1 else 2 * n


def dct(x, type: int = 2, axis: int = -1, norm=None):
    """DCT along `axis` (types 1-4, scipy.fft semantics)."""
    norm = _norm_opt(norm)
    if norm == "forward":
        # scipy puts the whole round-trip scale on the forward transform
        n = jnp.shape(x)[axis]
        return dct(x, type, axis, None) / jnp.float32(
            _roundtrip_factor(type, n))
    if type == 1:
        return _dct1(x, axis, norm)
    if type == 2:
        return _dct2(x, axis, norm)
    if type == 3:
        return _dct3(x, axis, norm)
    if type == 4:
        return _dct4(x, axis, norm)
    raise NotImplementedError(f"DCT type {type} (supported: 1-4)")


def idct(x, type: int = 2, axis: int = -1, norm=None):
    """Inverse DCT (scipy semantics: the inverse of `dct(type=...)`)."""
    norm = _norm_opt(norm)
    n = jnp.shape(x)[axis]
    if norm == "forward":
        # the forward carried the whole scale, so the inverse is the raw
        # transpose-pair transform (DCT-II <-> DCT-III; I/IV self-paired)
        pair = {1: 1, 2: 3, 3: 2, 4: 4}[type]
        return dct(x, pair, axis, None)
    if type == 1:
        # DCT-I is self-inverse up to 2(n-1) (ortho: exactly self-inverse)
        if norm == "ortho":
            return _dct1(x, axis, "ortho")
        return _dct1(x, axis, None) / jnp.float32(2 * (n - 1))
    if type == 2:
        if norm == "ortho":
            return _dct3(x, axis, "ortho")
        return _idct2_core(x, axis)  # backward: exact inverse incl. 1/(2n)
    if type == 3:
        if norm == "ortho":
            return _dct2(x, axis, "ortho")
        y = _dct2(x, axis, None)
        return y / jnp.float32(2 * n)
    if type == 4:
        # DCT-IV is self-inverse up to 2n (ortho: exactly self-inverse)
        if norm == "ortho":
            return _dct4(x, axis, "ortho")
        return _dct4(x, axis, None) / jnp.float32(2 * n)
    raise NotImplementedError(f"IDCT type {type} (supported: 1-4)")


def _dct1(x, axis, norm):
    """DCT-I via the even-symmetric extension of length 2(n-1):
    X[k] = Re(FFT([x0..x_{n-1}, x_{n-2}..x_1]))[k] — bins 0..n-1 are
    exactly the R2C half spectrum of the real extension, so this is one
    R2C."""
    from ..ops.rfft import rfft_last_split

    xr, _ = promote_to_split(x)
    n = xr.shape[axis]
    if n < 2:
        raise ValueError("DCT-I requires n >= 2")

    def impl(v):
        v = jnp.moveaxis(v, axis, -1)
        if norm == "ortho":
            # scipy's orthogonal DCT-I: endpoints scaled sqrt(2) on input,
            # 1/sqrt(2) on output, overall 1/sqrt(2(n-1)).
            s = np.ones(n, np.float32)
            s[0] = s[-1] = np.sqrt(2.0, dtype=np.float64).astype(np.float32)
            v = v * jnp.asarray(s)
        ext = jnp.concatenate([v, jnp.flip(v[..., 1:-1], axis=-1)], axis=-1)
        Vr, _ = rfft_last_split(ext, None)  # m//2+1 == n bins
        X = Vr[..., :n]
        if norm == "ortho":
            s = np.full(n, 1.0 / np.sqrt(2.0 * (n - 1)), np.float32)
            s[0] = s[-1] = s[0] / np.sqrt(2.0)
            X = X * jnp.asarray(s)
        return jnp.moveaxis(X, -1, axis)

    key = ("dct1", jax.default_backend(), _sk(xr), axis, norm)
    return _cc(key, impl, xr)


def _dct4(x, axis, norm):
    """DCT-IV via one modulated C2C FFT of the even-odd permuted input:
    with u[m] = s_m * x[perm][m] (s=-1 on the mirrored half) the identity
    X4[k] = 2*Re( e^{-i pi (2k+1)/(4n)} * FFT(u * e^{-i pi m / n})[k] )."""
    from ..plan.plan import get_plan

    xr, _ = promote_to_split(x)
    n = xr.shape[axis]
    perm = _even_odd_perm(n)
    signs = np.ones(n, np.float32)
    signs[(n + 1) // 2:] = -1.0  # mirrored (odd-origin) half of the perm
    m = np.arange(n, dtype=np.float64)
    pre = np.exp(-1j * np.pi * m / n)  # f64-generated modulation
    post = np.exp(-1j * np.pi * (2 * m + 1) / (4.0 * n))
    prer = jnp.asarray((signs * pre.real).astype(np.float32))
    prei = jnp.asarray((signs * pre.imag).astype(np.float32))
    postr = jnp.asarray(post.real.astype(np.float32))
    posti = jnp.asarray(post.imag.astype(np.float32))
    permj = jnp.asarray(perm)
    p = get_plan(n, "auto")

    def impl(v):
        v = jnp.moveaxis(v, axis, -1)
        u = jnp.take(v, permj, axis=-1)
        Vr, Vi = p._execute_split(u * prer, u * prei, -1, None)
        X = 2.0 * (Vr * postr - Vi * posti)
        if norm == "ortho":
            X = X * jnp.float32(1.0 / np.sqrt(2.0 * n))
        return jnp.moveaxis(X, -1, axis)

    key = ("dct4", jax.default_backend(), _sk(xr), axis, norm)
    return _cc(key, impl, xr)


def _dct2(x, axis, norm):
    from ..plan.plan import get_plan

    xr, _ = promote_to_split(x)
    n = xr.shape[axis]
    perm = jnp.asarray(_even_odd_perm(n))
    cr, ci = _halfshift_np(n, -1)
    cr = jnp.asarray(cr)
    ci = jnp.asarray(ci)
    p = get_plan(n, "auto")

    def impl(v):
        v = jnp.moveaxis(v, axis, -1)
        w = jnp.take(v, perm, axis=-1)
        Vr, Vi = p._execute_split(w, jnp.zeros_like(w), -1, None)
        X = 2.0 * (Vr * cr - Vi * ci)  # 2*Re(e^{-i pi k/2n} V[k])
        if norm == "ortho":
            sc = np.full(n, 1.0 / np.sqrt(2.0 * n), np.float32)
            sc[0] = 1.0 / np.sqrt(4.0 * n)
            X = X * jnp.asarray(sc)
        return jnp.moveaxis(X, -1, axis)

    key = ("dct2", jax.default_backend(), _sk(xr), axis, norm)
    return _cc(key, impl, xr)


def _idct2_core(x, axis):
    """Backward-norm inverse of DCT-II:
    invperm(Re(IFFT( 0.5 * e^{+i pi k/2n} * (Y - i*Yrev) )))."""
    from ..plan.plan import get_plan

    Yr, _ = promote_to_split(x)
    n = Yr.shape[axis]
    cr, ci = _halfshift_np(n, +1)  # e^{+i pi k / 2n}
    cr = jnp.asarray(cr)
    ci = jnp.asarray(ci)
    inv_perm = jnp.asarray(np.argsort(_even_odd_perm(n)).astype(np.int32))
    p = get_plan(n, "auto")

    def impl(Y):
        Y = jnp.moveaxis(Y, axis, -1)
        Yt = jnp.concatenate(
            [jnp.zeros_like(Y[..., :1]), jnp.flip(Y[..., 1:], axis=-1)],
            axis=-1,
        )
        # 0.5*(Y - i*Yt)*(cr + i*ci)
        Vr = 0.5 * (Y * cr + Yt * ci)
        Vi = 0.5 * (Y * ci - Yt * cr)
        vr, _ = p._execute_split(Vr, Vi, +1, 1.0 / n)
        out = jnp.take(vr, inv_perm, axis=-1)
        return jnp.moveaxis(out, -1, axis)

    key = ("idct2", jax.default_backend(), _sk(Yr), axis)
    return _cc(key, impl, Yr)


def _dct3(x, axis, norm):
    """DCT-III: backward = 2n * idct2_core; ortho = backward with the input
    pre-scaled by [1/sqrt(n), 1/sqrt(2n), ...]."""
    xr, _ = promote_to_split(x)
    n = xr.shape[axis]
    if norm == "ortho":
        sc = np.full(n, 1.0 / np.sqrt(2.0 * n), np.float32)
        sc[0] = 1.0 / np.sqrt(float(n))
        xr = jnp.moveaxis(jnp.moveaxis(xr, axis, -1) * jnp.asarray(sc), -1, axis)
    y = _idct2_core(xr, axis)
    return y * jnp.float32(2 * n)


def dst(x, type: int = 2, axis: int = -1, norm=None):
    """DST-II/III via the DCT identity
    DST2(x) = reverse( DCT2( (-1)^j * x ) )  and its transpose for type 3.
    (Sign-flip and reversal are orthogonal maps, so norms carry over.)"""
    norm = _norm_opt(norm)
    xr, _ = promote_to_split(x)
    n = xr.shape[axis]
    signs = jnp.asarray(((-1.0) ** np.arange(n)).astype(np.float32))

    if type == 1:
        if norm == "forward":
            return _dst1(xr, axis, None) / jnp.float32(2 * (n + 1))
        return _dst1(xr, axis, norm)
    if type == 2:
        v = jnp.moveaxis(xr, axis, -1) * signs
        v = jnp.moveaxis(v, -1, axis)
        y = dct(v, type=2, axis=axis, norm=norm)
        return jnp.flip(y, axis=axis)
    if type == 3:
        v = jnp.flip(xr, axis=axis)
        y = dct(v, type=3, axis=axis, norm=norm)
        y = jnp.moveaxis(y, axis, -1) * signs
        return jnp.moveaxis(y, -1, axis)
    if type == 4:
        # DST-IV(x)[k] = (-1)^k * DCT-IV(reverse(x))[k]; both maps are
        # orthogonal so the norm carries over unchanged.
        v = jnp.flip(xr, axis=axis)
        y = dct(v, type=4, axis=axis, norm=norm)
        y = jnp.moveaxis(y, axis, -1) * signs
        return jnp.moveaxis(y, -1, axis)
    raise NotImplementedError(f"DST type {type} (supported: 1-4)")


def _dst1(xr, axis, norm):
    """DST-I via the odd-symmetric extension of length 2(n+1):
    X[k] = -Im(FFT([0, x0..x_{n-1}, 0, -x_{n-1}..-x0]))[k+1] — bins
    1..n sit inside the R2C half spectrum (m//2+1 == n+2 bins), so this
    is one R2C."""
    from ..ops.rfft import rfft_last_split

    n = xr.shape[axis]

    def impl(v):
        v = jnp.moveaxis(v, axis, -1)
        z = jnp.zeros_like(v[..., :1])
        ext = jnp.concatenate([z, v, z, -jnp.flip(v, axis=-1)], axis=-1)
        _, Vi = rfft_last_split(ext, None)
        X = -Vi[..., 1 : n + 1]
        if norm == "ortho":
            X = X * jnp.float32(1.0 / np.sqrt(2.0 * (n + 1)))
        return jnp.moveaxis(X, -1, axis)

    key = ("dst1", jax.default_backend(), _sk(xr), axis, norm)
    return _cc(key, impl, xr)


def idst(x, type: int = 2, axis: int = -1, norm=None):
    """Inverse DST (scipy semantics)."""
    norm = _norm_opt(norm)
    n = jnp.shape(x)[axis]
    if norm == "forward":
        pair = {1: 1, 2: 3, 3: 2, 4: 4}[type]
        return dst(x, pair, axis, None)
    if type == 1:
        if norm == "ortho":
            return dst(x, type=1, axis=axis, norm="ortho")
        return dst(x, type=1, axis=axis) / jnp.float32(2 * (n + 1))
    if type == 2:
        if norm == "ortho":
            return dst(x, type=3, axis=axis, norm="ortho")
        return dst(x, type=3, axis=axis) / jnp.float32(2 * n)
    if type == 3:
        if norm == "ortho":
            return dst(x, type=2, axis=axis, norm="ortho")
        return dst(x, type=2, axis=axis) / jnp.float32(2 * n)
    if type == 4:
        if norm == "ortho":
            return dst(x, type=4, axis=axis, norm="ortho")
        return dst(x, type=4, axis=axis) / jnp.float32(2 * n)
    raise NotImplementedError(f"IDST type {type} (supported: 1-4)")


def _apply_nd(fn1d, x, type, s, axes, norm):
    """Separable N-D transform: the 1-D transform applied per axis
    (scipy.fft.dctn semantics: `s` trims/zero-pads each axis first, and
    with axes=None it selects the LAST len(s) axes).  The whole chain —
    resizes and every per-axis pass — traces into ONE jitted program
    (CLAUDE.md: no eager op chains)."""
    nd = jnp.ndim(x)
    if axes is None:
        if s is not None and len(s) > nd:
            raise ValueError(
                f"shape requires {len(s)} axes but input has {nd} "
                f"dimensions")
        axes = tuple(range(nd - len(s), nd)) if s is not None \
            else tuple(range(nd))
    for a in axes:
        if not -nd <= a < nd:
            raise ValueError(
                f"axis {a} is out of bounds for array of dimension {nd}")
    axes = tuple(a % nd for a in axes)
    if s is not None and len(s) != len(axes):
        raise ValueError("s and axes must have the same length")

    def impl(v):
        if s is not None:
            from .rfft import _resize_axis

            for sz, ax in zip(s, axes):
                if sz is not None and v.shape[ax] != sz:
                    v = _resize_axis(v, sz, ax)
        for ax in axes:
            v = fn1d(v, type=type, axis=ax, norm=norm)
        return v

    key = ("ndsep", jax.default_backend(), getattr(fn1d, "__name__", str(fn1d)),
           _sk(jnp.asarray(x)), type, None if s is None else tuple(s),
           None if axes is None else tuple(axes), norm)
    return _cc(key, impl, jnp.asarray(x))


def dctn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D DCT as separable 1-D DCTs over `axes` (scipy.fft.dctn)."""
    return _apply_nd(dct, x, type, s, axes, norm)


def idctn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D inverse DCT (scipy.fft.idctn)."""
    return _apply_nd(idct, x, type, s, axes, norm)


def dstn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D DST as separable 1-D DSTs over `axes` (scipy.fft.dstn)."""
    return _apply_nd(dst, x, type, s, axes, norm)


def idstn(x, type: int = 2, s=None, axes=None, norm=None):
    """N-D inverse DST (scipy.fft.idstn)."""
    return _apply_nd(idst, x, type, s, axes, norm)
