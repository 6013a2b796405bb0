"""Non-uniform FFT (NUFFT), types 1 and 2, 1-D and 2-D.

New capability beyond the reference (which is uniform C2C only — SURVEY
§2) and beyond scipy.fft: the FINUFFT-style algorithm (Dutt-Rokhlin /
Greengard-Lee) on the library's FFT stack.

    type 1 ("adjoint"): nonuniform samples  -> uniform Fourier modes
        f_k = sum_j c_j exp(isign * i k x_j),   k = -n//2 .. n-n//2-1
    type 2 ("forward"): uniform Fourier modes -> nonuniform samples
        c_j = sum_k f_k exp(isign * i k x_j)

Mode ordering follows finufft: k ASCENDING (fftshifted), and the default
signs are isign=+1 for type 1, isign=-1 for type 2 (so the pair is an
adjoint/forward pair).

Algorithm (each call is ONE jitted program):
  1. oversampled fine grid of size nf = next_fast_len(2n),
  2. spread (type 1: one vectorized [M, w] scatter-add) / interpolate
     (type 2: one [M, w] gather) with a truncated Gaussian window,
  3. uniform FFT on the fine grid through the framework's kernels,
  4. deconvolve by the window's exact Fourier transform h/phi_hat(k).

Window math: phi(x) = exp(-x^2 / 4 tau), phi_hat(k) =
2 sqrt(pi tau) exp(-k^2 tau).  Balancing the truncation error
exp(-(M_sp h)^2 / 4 tau) against the worst aliasing ratio
exp(-tau nf^2 (1 - 1/sigma)) gives tau = pi M_sp / (nf^2 sqrt(1-1/sigma))
with error ~ exp(-pi M_sp sqrt(1-1/sigma)) — M_sp = 7 points per side
(w = 14) lands at ~2e-7, i.e. the f32 floor.  Tests pin 5e-5 vs the
direct NUDFT oracle (tests/test_nufft.py).

x_j are float32 radians (any real values are wrapped to [0, 2pi)); all
complex boundaries are split (re, im) pairs internally.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge, promote_to_split

__all__ = ["nufft1d1", "nufft1d2", "nufft1d3", "nufft2d1",
           "nufft2d3", "nufft3d3",
           "nufft2d2", "nufft3d1", "nufft3d2"]

_SIGMA = 2.0  # oversampling factor
_WIDTH = 14   # spreading width in fine-grid points (M_sp = 7 per side)


def _fine_n(n: int) -> int:
    from .helpers import next_fast_len

    return next_fast_len(int(_SIGMA * n))


def _tau(nf: int) -> float:
    m_sp = _WIDTH // 2
    return math.pi * m_sp / (nf * nf * math.sqrt(1.0 - 1.0 / _SIGMA))


def _window_weights(x, nf):
    """For points x [M] (radians), return (i0 [M] int32 base fine-grid
    index, wts [M, w] Gaussian window weights)."""
    h = 2.0 * math.pi / nf
    tau = _tau(nf)
    xi = x * (1.0 / h)  # fine-grid units
    i0 = jnp.floor(xi).astype(jnp.int32) - (_WIDTH // 2 - 1)
    l = jnp.arange(_WIDTH, dtype=jnp.float32)[None, :]
    d = (xi[:, None] - (i0[:, None].astype(jnp.float32) + l)) * h
    return i0, jnp.exp(-(d * d) * (1.0 / (4.0 * tau)))


def _deconv(n: int, nf: int):
    """h / phi_hat(k) for the kept modes, in FFT BIN order (f64 host
    precompute, cast once — framework table discipline)."""
    tau = _tau(nf)
    k = np.fft.fftfreq(n, 1.0 / n)  # bin order: 0..ceil-1, -floor..-1
    ph = 2.0 * math.sqrt(math.pi * tau) * np.exp(-(k * k) * tau)
    return jnp.asarray((2.0 * math.pi / nf) / ph, jnp.float32)


def _wrap(x):
    two_pi = jnp.float32(2.0 * math.pi)
    return jnp.mod(jnp.asarray(x, jnp.float32), two_pi)


def _gather_idx(i0, nf):
    return jnp.mod(i0[:, None] + jnp.arange(_WIDTH, dtype=jnp.int32), nf)


def nufft1d1(x, c, n: int, *, isign: int = +1):
    """Type-1 NUFFT: f_k = sum_j c_j e^{isign i k x_j}, k ascending
    (finufft ordering).  x: [M] radians; c: [..., M] -> [..., n]."""
    cr, ci = promote_to_split(c)
    return merge(*_impl_1d1(jnp.asarray(x, jnp.float32), cr, ci,
                            n=n, nf=_fine_n(n), isign=int(isign >= 0)))


# One jitted program per (n, nf, isign, shapes) — module-level with static
# config so repeat calls replay the compiled executable (framework
# invariant: no per-call retraces, no eager op chains).
@partial(jax.jit, static_argnames=("n", "nf", "isign"))
def _impl_1d1(x, cr, ci, *, n, nf, isign):
    from .transforms import fft as _fft

    dec = _deconv(n, nf)
    pos, neg = n - n // 2, n // 2
    x = _wrap(x)
    i0, wts = _window_weights(x, nf)
    idx = _gather_idx(i0, nf)
    lead = cr.shape[:-1]
    gr = jnp.zeros((*lead, nf), jnp.float32)
    gi = jnp.zeros((*lead, nf), jnp.float32)
    gr = gr.at[..., idx].add(cr[..., :, None] * wts)
    gi = gi.at[..., idx].add(ci[..., :, None] * wts)
    # fine-grid FFT is e^{-iku}; isign=+1 runs it on the conjugate
    if isign:
        Fr, Fi = promote_to_split(_fft(merge(gr, -gi)))
        Fi = -Fi
    else:
        Fr, Fi = promote_to_split(_fft(merge(gr, gi)))
    # central modes in bin order, deconvolve, fftshift (k ascending)
    br = jnp.concatenate([Fr[..., :pos], Fr[..., nf - neg:]], -1) * dec
    bi = jnp.concatenate([Fi[..., :pos], Fi[..., nf - neg:]], -1) * dec
    return jnp.roll(br, neg, -1), jnp.roll(bi, neg, -1)


def nufft1d2(x, f, *, isign: int = -1):
    """Type-2 NUFFT: c_j = sum_k f_k e^{isign i k x_j}; f: [..., n] with
    k ascending (finufft ordering) -> [..., M]."""
    fr, fi = promote_to_split(f)
    n = fr.shape[-1]
    return merge(*_impl_1d2(jnp.asarray(x, jnp.float32), fr, fi,
                            n=n, nf=_fine_n(n), isign=int(isign >= 0)))


@partial(jax.jit, static_argnames=("n", "nf", "isign"))
def _impl_1d2(x, fr, fi, *, n, nf, isign):
    from .transforms import ifft_unnormalized as _ifft_un

    dec = _deconv(n, nf)
    pos, neg = n - n // 2, n // 2
    x = _wrap(x)
    # k-ascending -> bin order, deconvolve, zero-pad to the fine grid
    br = jnp.roll(fr, -neg, -1) * dec
    bi = jnp.roll(fi, -neg, -1) * dec
    lead = br.shape[:-1]
    pad = jnp.zeros((*lead, nf - n), jnp.float32)
    gr = jnp.concatenate([br[..., :pos], pad, br[..., pos:]], -1)
    gi = jnp.concatenate([bi[..., :pos], pad, bi[..., pos:]], -1)
    # unnormalized inverse is e^{+iku}; isign=-1 runs the conjugate
    if isign:
        Gr, Gi = promote_to_split(_ifft_un(merge(gr, gi)))
    else:
        Gr, Gi = promote_to_split(_ifft_un(merge(gr, -gi)))
        Gi = -Gi
    i0, wts = _window_weights(x, nf)
    idx = _gather_idx(i0, nf)
    cr = jnp.sum(Gr[..., idx] * wts, axis=-1)
    ci = jnp.sum(Gi[..., idx] * wts, axis=-1)
    return cr, ci


def _central(a, n, nf, axis):
    pos, neg = n - n // 2, n // 2
    lo = jax.lax.slice_in_dim(a, 0, pos, axis=axis)
    hi = jax.lax.slice_in_dim(a, nf - neg, nf, axis=axis)
    return jnp.roll(jnp.concatenate([lo, hi], axis=axis), neg, axis=axis)


def _expand(a, n, nf, axis):
    pos, neg = n - n // 2, n // 2
    a = jnp.roll(a, -neg, axis=axis)
    lo = jax.lax.slice_in_dim(a, 0, pos, axis=axis)
    hi = jax.lax.slice_in_dim(a, pos, n, axis=axis)
    shp = list(a.shape)
    shp[axis] = nf - n
    return jnp.concatenate([lo, jnp.zeros(shp, a.dtype), hi], axis=axis)


def nufft2d1(x, y, c, ns, *, isign: int = +1):
    """2-D type 1: f_{k1,k2} = sum_j c_j e^{isign i (k1 x_j + k2 y_j)};
    ns = (n1, n2); c: [..., M] -> [..., n1, n2], both k axes ascending."""
    n1, n2 = ns
    cr, ci = promote_to_split(c)
    return merge(*_impl_2d1(jnp.asarray(x, jnp.float32),
                            jnp.asarray(y, jnp.float32), cr, ci,
                            n1=n1, n2=n2, isign=int(isign >= 0)))


@partial(jax.jit, static_argnames=("n1", "n2", "isign"))
def _impl_2d1(x, y, cr, ci, *, n1, n2, isign):
    from .nd import fftn

    nf1, nf2 = _fine_n(n1), _fine_n(n2)
    s1 = jnp.roll(_deconv(n1, nf1), n1 // 2)[:, None]
    s2 = jnp.roll(_deconv(n2, nf2), n2 // 2)[None, :]
    x, y = _wrap(x), _wrap(y)
    i0x, wx = _window_weights(x, nf1)
    i0y, wy = _window_weights(y, nf2)
    flat = (_gather_idx(i0x, nf1)[:, :, None] * nf2
            + _gather_idx(i0y, nf2)[:, None, :])  # [M, w, w]
    w2 = wx[:, :, None] * wy[:, None, :]
    lead = cr.shape[:-1]
    gr = jnp.zeros((*lead, nf1 * nf2), jnp.float32)
    gi = jnp.zeros((*lead, nf1 * nf2), jnp.float32)
    gr = gr.at[..., flat].add(cr[..., :, None, None] * w2)
    gi = gi.at[..., flat].add(ci[..., :, None, None] * w2)
    gr = gr.reshape(*lead, nf1, nf2)
    gi = gi.reshape(*lead, nf1, nf2)
    if isign:
        Fr, Fi = promote_to_split(fftn(merge(gr, -gi), axes=(-2, -1)))
        Fi = -Fi
    else:
        Fr, Fi = promote_to_split(fftn(merge(gr, gi), axes=(-2, -1)))
    Fr = _central(_central(Fr, n1, nf1, -2), n2, nf2, -1)
    Fi = _central(_central(Fi, n1, nf1, -2), n2, nf2, -1)
    return Fr * s1 * s2, Fi * s1 * s2


def nufft2d2(x, y, f, *, isign: int = -1):
    """2-D type 2: c_j = sum_{k1,k2} f_{k1,k2} e^{isign i (k1 x_j +
    k2 y_j)}; f: [..., n1, n2] with both k axes ascending -> [..., M]."""
    fr, fi = promote_to_split(f)
    n1, n2 = fr.shape[-2], fr.shape[-1]
    return merge(*_impl_2d2(jnp.asarray(x, jnp.float32),
                            jnp.asarray(y, jnp.float32), fr, fi,
                            n1=n1, n2=n2, isign=int(isign >= 0)))


@partial(jax.jit, static_argnames=("n1", "n2", "isign"))
def _impl_2d2(x, y, fr, fi, *, n1, n2, isign):
    from .nd import ifftn

    nf1, nf2 = _fine_n(n1), _fine_n(n2)
    s1 = jnp.roll(_deconv(n1, nf1), n1 // 2)[:, None]
    s2 = jnp.roll(_deconv(n2, nf2), n2 // 2)[None, :]
    x, y = _wrap(x), _wrap(y)
    gr = _expand(_expand(fr * s1 * s2, n1, nf1, -2), n2, nf2, -1)
    gi = _expand(_expand(fi * s1 * s2, n1, nf1, -2), n2, nf2, -1)
    total = float(nf1 * nf2)
    if isign:
        Gr, Gi = promote_to_split(ifftn(merge(gr, gi), axes=(-2, -1)))
        Gr, Gi = Gr * total, Gi * total
    else:
        Gr, Gi = promote_to_split(ifftn(merge(gr, -gi), axes=(-2, -1)))
        Gr, Gi = Gr * total, -Gi * total
    i0x, wx = _window_weights(x, nf1)
    i0y, wy = _window_weights(y, nf2)
    flat = (_gather_idx(i0x, nf1)[:, :, None] * nf2
            + _gather_idx(i0y, nf2)[:, None, :])
    w2 = wx[:, :, None] * wy[:, None, :]
    Grf = Gr.reshape(*Gr.shape[:-2], nf1 * nf2)
    Gif = Gi.reshape(*Gi.shape[:-2], nf1 * nf2)
    cr = jnp.sum(Grf[..., flat] * w2, axis=(-2, -1))
    ci = jnp.sum(Gif[..., flat] * w2, axis=(-2, -1))
    return cr, ci


def nufft1d3(x, c, s, *, isign: int = +1):
    """Type-3 NUFFT: f_k = sum_j c_j e^{isign i s_k x_j} for ARBITRARY
    real points x_j and frequencies s_k (finufft nufft1d3 semantics).

    Reduction to type 2 (Lee-Greengard): center both sets, spread c_j
    with a Gaussian phi onto a free-space grid u_i = i*h (h = pi/(2S) so
    every target maps to theta_k = s_k*h inside (-pi/2, pi/2]), note
    g_hat(s) = phi_hat(s) * f(s) exactly, and evaluate the semi-discrete
    transform h * sum_i g_i e^{isign i s u_i} — which IS a type-2 NUFFT
    with mode index i and points theta_k — then deconvolve by
    phi_hat(s_k).  tau balances spreading truncation vs sampling
    aliasing at the same ~e^{-1.1 w} error as the uniform-grid window.
    """
    cr, ci = promote_to_split(c)
    x = jnp.asarray(x, jnp.float32)
    s = jnp.asarray(s, jnp.float32)
    (xc, sc, h, tau, n) = _t3_geom(x, s)
    return merge(*_impl_1d3(x, cr, ci, s, n=n, h=h, tau=tau, xc=xc, sc=sc,
                            isign=int(isign >= 0)))


def _t3_geom(x, s):
    """Per-dimension type-3 geometry (xc, sc, h, tau, n): centers/extents
    are data-dependent and become STATIC trace constants, so each new
    point-set geometry compiles its own program — repeated transforms
    over the same geometry (the common iterative-reconstruction pattern)
    replay the cached one."""
    xh = np.asarray(x, np.float64)
    sh = np.asarray(s, np.float64)
    xc = float((xh.max() + xh.min()) / 2.0) if xh.size else 0.0
    sc = float((sh.max() + sh.min()) / 2.0) if sh.size else 0.0
    X = max(float(np.abs(xh - xc).max()) if xh.size else 0.0, 1e-30)
    S = max(float(np.abs(sh - sc).max()) if sh.size else 0.0, 1e-30)
    h = math.pi / (_SIGMA * S)
    tau = _WIDTH * h / (8.0 * math.sqrt(2.0) * S)
    from .helpers import next_fast_len

    n = next_fast_len(2 * (int(math.ceil(X / h)) + _WIDTH + 2))
    return xc, sc, h, tau, n


def _t3_phase(cr, ci, ph):
    """Multiply the split pair by e^{i ph} (elementwise)."""
    cph, sph = jnp.cos(ph), jnp.sin(ph)
    return cr * cph - ci * sph, cr * sph + ci * cph


def _t3_spread_weights(xp, h, tau, n):
    """Free-space Gaussian spreading stencil for centered points xp on
    the grid u_i = (i - n/2) h: returns (idx [M, W], wts [M, W])."""
    xi = xp * jnp.float32(1.0 / h) + jnp.float32(n // 2)
    i0 = jnp.floor(xi).astype(jnp.int32) - (_WIDTH // 2 - 1)
    l = jnp.arange(_WIDTH, dtype=jnp.float32)[None, :]
    d = (xi[:, None] - (i0[:, None].astype(jnp.float32) + l)) * jnp.float32(h)
    wts = jnp.exp(-(d * d) * jnp.float32(1.0 / (4.0 * tau)))
    idx = jnp.clip(i0[:, None] + jnp.arange(_WIDTH, dtype=jnp.int32), 0,
                   n - 1)
    return idx, wts


def nufft2d3(x, y, c, s, t, *, isign: int = +1):
    """2-D type-3 NUFFT: f_k = sum_j c_j e^{isign i (s_k x_j + t_k y_j)}
    for arbitrary points (x, y)_j and frequencies (s, t)_k (finufft
    nufft2d3 semantics).  Separable Lee-Greengard reduction to type 2:
    per-dimension geometry from _t3_geom, product Gaussian spreading,
    one _impl_2d2 evaluation, product deconvolution."""
    cr, ci = promote_to_split(c)
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    s = jnp.asarray(s, jnp.float32)
    t = jnp.asarray(t, jnp.float32)
    g1 = _t3_geom(x, s)
    g2 = _t3_geom(y, t)
    return merge(*_impl_2d3(x, y, cr, ci, s, t, g1=g1, g2=g2,
                            isign=int(isign >= 0)))


@partial(jax.jit, static_argnames=("g1", "g2", "isign"))
def _impl_2d3(x, y, cr, ci, s, t, *, g1, g2, isign):
    sgn = 1.0 if isign else -1.0
    (xc, sc, h1, tau1, n1) = g1
    (yc, tc, h2, tau2, n2) = g2
    xp, yp = x - jnp.float32(xc), y - jnp.float32(yc)
    sp, tp = s - jnp.float32(sc), t - jnp.float32(tc)
    # source-side center phase e^{isign i (sc x' + tc y')}
    c2r, c2i = _t3_phase(cr, ci, sgn * (jnp.float32(sc) * xp
                                        + jnp.float32(tc) * yp))
    ix, wx = _t3_spread_weights(xp, h1, tau1, n1)
    iy, wy = _t3_spread_weights(yp, h2, tau2, n2)
    flat = ix[:, :, None] * n2 + iy[:, None, :]
    w2 = wx[:, :, None] * wy[:, None, :]
    lead = cr.shape[:-1]
    gr = jnp.zeros((*lead, n1 * n2), jnp.float32)
    gi = jnp.zeros((*lead, n1 * n2), jnp.float32)
    gr = gr.at[..., flat].add(c2r[..., :, None, None] * w2)
    gi = gi.at[..., flat].add(c2i[..., :, None, None] * w2)
    gr = gr.reshape(*lead, n1, n2)
    gi = gi.reshape(*lead, n1, n2)
    th1 = sp * jnp.float32(h1)
    th2 = tp * jnp.float32(h2)
    vr, vi = _impl_2d2(th1, th2, gr, gi, n1=n1, n2=n2, isign=isign)
    # product deconvolution + uncentered-frequency center phase
    amp = (jnp.float32(h1 * h2
                       / (4.0 * math.pi * math.sqrt(tau1 * tau2)))
           * jnp.exp(sp * sp * jnp.float32(tau1)
                     + tp * tp * jnp.float32(tau2)))
    ph2 = sgn * (s * jnp.float32(xc) + t * jnp.float32(yc))
    c2, s2 = jnp.cos(ph2) * amp, jnp.sin(ph2) * amp
    return vr * c2 - vi * s2, vr * s2 + vi * c2


def nufft3d3(x, y, z, c, s, t, u, *, isign: int = +1):
    """3-D type-3 NUFFT: f_k = sum_j c_j e^{isign i (s x + t y + u z)}
    (finufft nufft3d3 semantics); see nufft2d3."""
    cr, ci = promote_to_split(c)
    arrs = [jnp.asarray(v, jnp.float32) for v in (x, y, z, s, t, u)]
    x, y, z, s, t, u = arrs
    g1, g2, g3 = _t3_geom(x, s), _t3_geom(y, t), _t3_geom(z, u)
    return merge(*_impl_3d3(x, y, z, cr, ci, s, t, u, g1=g1, g2=g2, g3=g3,
                            isign=int(isign >= 0)))


@partial(jax.jit, static_argnames=("g1", "g2", "g3", "isign"))
def _impl_3d3(x, y, z, cr, ci, s, t, u, *, g1, g2, g3, isign):
    sgn = 1.0 if isign else -1.0
    (xc, sc, h1, tau1, n1) = g1
    (yc, tc, h2, tau2, n2) = g2
    (zc, uc, h3, tau3, n3) = g3
    xp, yp, zp = (x - jnp.float32(xc), y - jnp.float32(yc),
                  z - jnp.float32(zc))
    sp, tp, up = (s - jnp.float32(sc), t - jnp.float32(tc),
                  u - jnp.float32(uc))
    c2r, c2i = _t3_phase(cr, ci, sgn * (jnp.float32(sc) * xp
                                        + jnp.float32(tc) * yp
                                        + jnp.float32(uc) * zp))
    ix, wx = _t3_spread_weights(xp, h1, tau1, n1)
    iy, wy = _t3_spread_weights(yp, h2, tau2, n2)
    iz, wz = _t3_spread_weights(zp, h3, tau3, n3)
    flat = (ix[:, :, None, None] * (n2 * n3)
            + iy[:, None, :, None] * n3 + iz[:, None, None, :])
    w3 = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    lead = cr.shape[:-1]
    gr = jnp.zeros((*lead, n1 * n2 * n3), jnp.float32)
    gi = jnp.zeros((*lead, n1 * n2 * n3), jnp.float32)
    gr = gr.at[..., flat].add(c2r[..., :, None, None, None] * w3)
    gi = gi.at[..., flat].add(c2i[..., :, None, None, None] * w3)
    gr = gr.reshape(*lead, n1, n2, n3)
    gi = gi.reshape(*lead, n1, n2, n3)
    vr, vi = _impl_3d2(sp * jnp.float32(h1), tp * jnp.float32(h2),
                       up * jnp.float32(h3), gr, gi,
                       n1=n1, n2=n2, n3=n3, isign=isign)
    amp = (jnp.float32(h1 * h2 * h3
                       / (8.0 * math.pi ** 1.5
                          * math.sqrt(tau1 * tau2 * tau3)))
           * jnp.exp(sp * sp * jnp.float32(tau1)
                     + tp * tp * jnp.float32(tau2)
                     + up * up * jnp.float32(tau3)))
    ph2 = sgn * (s * jnp.float32(xc) + t * jnp.float32(yc)
                 + u * jnp.float32(zc))
    c2, s2 = jnp.cos(ph2) * amp, jnp.sin(ph2) * amp
    return vr * c2 - vi * s2, vr * s2 + vi * c2


@partial(jax.jit, static_argnames=("n", "h", "tau", "xc", "sc", "isign"))
def _impl_1d3(x, cr, ci, s, *, n, h, tau, xc, sc, isign):
    sgn = 1.0 if isign else -1.0
    xp = x - jnp.float32(xc)   # centered points
    sp = s - jnp.float32(sc)   # centered frequencies
    # c'_j = c_j e^{isign i sc x'_j} (center phase on the source side)
    c2r, c2i = _t3_phase(cr, ci, sgn * jnp.float32(sc) * xp)

    # free-space spread onto u_i = (i - n/2) h, i = 0..n-1 (no wrap: the
    # grid over-covers the point extent by construction)
    idx, wts = _t3_spread_weights(xp, h, tau, n)
    lead = cr.shape[:-1]
    gr = jnp.zeros((*lead, n), jnp.float32)
    gi = jnp.zeros((*lead, n), jnp.float32)
    gr = gr.at[..., idx].add(c2r[..., :, None] * wts)
    gi = gi.at[..., idx].add(c2i[..., :, None] * wts)

    # semi-discrete transform h * sum_i g_i e^{isign i s' u_i} via type 2
    # with mode index m = i - n/2 (ascending, nufft1d2's ordering) and
    # theta_k = s' h in (-pi/2, pi/2]
    theta = sp * jnp.float32(h)
    vr, vi = _impl_1d2(theta, gr, gi, n=n, nf=_fine_n(n), isign=isign)

    # deconvolve by phi_hat(s') = 2 sqrt(pi tau) e^{-s'^2 tau}, restore
    # the x-center phase e^{isign i s x_c} (at the UNcentered s), fold h
    amp = (jnp.float32(h) / jnp.float32(2.0 * math.sqrt(math.pi * tau))
           * jnp.exp(sp * sp * jnp.float32(tau)))
    ph2 = sgn * s * jnp.float32(xc)
    c2, s2 = jnp.cos(ph2) * amp, jnp.sin(ph2) * amp
    return vr * c2 - vi * s2, vr * s2 + vi * c2


def nufft3d1(x, y, z, c, ns, *, isign: int = +1):
    """3-D type 1: f_{k1,k2,k3} = sum_j c_j e^{isign i (k1 x + k2 y +
    k3 z)_j}; ns = (n1, n2, n3); c: [..., M] -> [..., n1, n2, n3]."""
    n1, n2, n3 = ns
    cr, ci = promote_to_split(c)
    return merge(*_impl_3d1(jnp.asarray(x, jnp.float32),
                            jnp.asarray(y, jnp.float32),
                            jnp.asarray(z, jnp.float32), cr, ci,
                            n1=n1, n2=n2, n3=n3, isign=int(isign >= 0)))


@partial(jax.jit, static_argnames=("n1", "n2", "n3", "isign"))
def _impl_3d1(x, y, z, cr, ci, *, n1, n2, n3, isign):
    from .nd import fftn

    nfs = [_fine_n(n) for n in (n1, n2, n3)]
    i0s, ws, idxs = [], [], []
    for pts, nf in zip((x, y, z), nfs):
        i0, w = _window_weights(_wrap(pts), nf)
        i0s.append(i0)
        ws.append(w)
        idxs.append(_gather_idx(i0, nf))
    flat = (idxs[0][:, :, None, None] * (nfs[1] * nfs[2])
            + idxs[1][:, None, :, None] * nfs[2]
            + idxs[2][:, None, None, :])  # [M, w, w, w]
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :])
    lead = cr.shape[:-1]
    tot = nfs[0] * nfs[1] * nfs[2]
    gr = jnp.zeros((*lead, tot), jnp.float32)
    gi = jnp.zeros((*lead, tot), jnp.float32)
    gr = gr.at[..., flat].add(cr[..., :, None, None, None] * w3)
    gi = gi.at[..., flat].add(ci[..., :, None, None, None] * w3)
    gr = gr.reshape(*lead, *nfs)
    gi = gi.reshape(*lead, *nfs)
    if isign:
        Fr, Fi = promote_to_split(fftn(merge(gr, -gi), axes=(-3, -2, -1)))
        Fi = -Fi
    else:
        Fr, Fi = promote_to_split(fftn(merge(gr, gi), axes=(-3, -2, -1)))
    for ax, (n, nf) in enumerate(zip((n1, n2, n3), nfs)):
        Fr = _central(Fr, n, nf, ax - 3)
        Fi = _central(Fi, n, nf, ax - 3)
    s1 = jnp.roll(_deconv(n1, nfs[0]), n1 // 2)[:, None, None]
    s2 = jnp.roll(_deconv(n2, nfs[1]), n2 // 2)[None, :, None]
    s3 = jnp.roll(_deconv(n3, nfs[2]), n3 // 2)[None, None, :]
    return Fr * s1 * s2 * s3, Fi * s1 * s2 * s3


def nufft3d2(x, y, z, f, *, isign: int = -1):
    """3-D type 2: c_j = sum_k f_k e^{isign i k.(x,y,z)_j};
    f: [..., n1, n2, n3] (all k axes ascending) -> [..., M]."""
    fr, fi = promote_to_split(f)
    n1, n2, n3 = fr.shape[-3], fr.shape[-2], fr.shape[-1]
    return merge(*_impl_3d2(jnp.asarray(x, jnp.float32),
                            jnp.asarray(y, jnp.float32),
                            jnp.asarray(z, jnp.float32), fr, fi,
                            n1=n1, n2=n2, n3=n3, isign=int(isign >= 0)))


@partial(jax.jit, static_argnames=("n1", "n2", "n3", "isign"))
def _impl_3d2(x, y, z, fr, fi, *, n1, n2, n3, isign):
    from .nd import ifftn

    nfs = [_fine_n(n) for n in (n1, n2, n3)]
    s1 = jnp.roll(_deconv(n1, nfs[0]), n1 // 2)[:, None, None]
    s2 = jnp.roll(_deconv(n2, nfs[1]), n2 // 2)[None, :, None]
    s3 = jnp.roll(_deconv(n3, nfs[2]), n3 // 2)[None, None, :]
    fr = fr * s1 * s2 * s3
    fi = fi * s1 * s2 * s3
    for ax, (n, nf) in enumerate(zip((n1, n2, n3), nfs)):
        fr = _expand(fr, n, nf, ax - 3)
        fi = _expand(fi, n, nf, ax - 3)
    total = float(nfs[0] * nfs[1] * nfs[2])
    if isign:
        Gr, Gi = promote_to_split(ifftn(merge(fr, fi), axes=(-3, -2, -1)))
        Gr, Gi = Gr * total, Gi * total
    else:
        Gr, Gi = promote_to_split(ifftn(merge(fr, -fi), axes=(-3, -2, -1)))
        Gr, Gi = Gr * total, -Gi * total
    idxs, ws = [], []
    for pts, nf in zip((x, y, z), nfs):
        i0, w = _window_weights(_wrap(pts), nf)
        idxs.append(_gather_idx(i0, nf))
        ws.append(w)
    flat = (idxs[0][:, :, None, None] * (nfs[1] * nfs[2])
            + idxs[1][:, None, :, None] * nfs[2]
            + idxs[2][:, None, None, :])
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :])
    Grf = Gr.reshape(*Gr.shape[:-3], -1)
    Gif = Gi.reshape(*Gi.shape[:-3], -1)
    cr = jnp.sum(Grf[..., flat] * w3, axis=(-3, -2, -1))
    ci = jnp.sum(Gif[..., flat] * w3, axis=(-3, -2, -1))
    return cr, ci
