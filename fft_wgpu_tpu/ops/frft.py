"""Fractional Fourier transform (Ozaktas-Kutay-Arikan fast algorithm).

`frft(x, a)` computes the order-`a` fractional Fourier transform on the
dimensionless grid x_n = (n - N/2) / sqrt(N): a=0 is the identity, a=1
the (centered, unitary) DFT, a=2 the parity operator, a=3 the inverse
DFT; fractional orders interpolate (F^a F^b = F^{a+b}).

ADMISSIBILITY (standard for chirp-based FrFT algorithms): fractional
orders are accurate for signals whose energy is concentrated inside the
dimensionless time-frequency disk |x|, |f| < sqrt(N)/2 — e.g. anything
with a decaying envelope and bounded bandwidth.  Signals that fill the
TF square to its corners (e.g. white noise) lose the corner content
(~40% L2 for pure noise); integer orders remain exact for ALL inputs.
Group properties (additivity, unitarity, roundtrip) hold to roundoff on
admissible signals and degrade together with the accuracy otherwise.

Algorithm (Ozaktas et al., "Digital computation of the fractional
Fourier transform", IEEE TSP 44(9), 1996): reduce a to the well-
conditioned interval [0.5, 1.5] with exact integer-order operators, then
decompose F^a = chirp-multiply . chirp-convolve . chirp-multiply on a 2x
sinc-upsampled grid.  Validated at 1e-15 against the direct continuous-
kernel quadrature inside the core interval (where the quadrature itself
is well-sampled) and by exact group properties everywhere else.

Design: every table (chirps, convolution-kernel spectra) is
f64-generated on the host and cast once (CLAUDE.md); the two linear
convolutions ride the framework's power-of-two plan cache as one jitted
program per (shape, a); data stays split (re, im).  The reference has no
fractional transforms (it is a bare batched FFT, SURVEY §2) — this is
part of the framework-completeness superset like ops/czt.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge, promote_to_split

__all__ = ["frft", "frft2", "dfrft"]


@functools.lru_cache(maxsize=64)
def _core_tables(n: int, a: float):
    """Host f64 tables for the core 0.5 <= a <= 1.5 decomposition.

    Returns (pre, post, sinc_spec, chirp_spec, L1, L2) where pre/post are
    split-f32 chirp tables of length 4n-3 (post includes the output scale
    and phase), and *_spec are split-f32 spectra of the sinc-interpolation
    kernel (padded to L1) and the chirp convolution kernel (padded to L2).
    """
    alpha = a * np.pi / 2.0
    tana2 = np.tan(alpha / 2.0)
    sina = np.sin(alpha)
    # chirp grids: the original center sample j = n//2 lands at upsampled
    # index 2*(n//2), so after the (n-1) zero-pad the signal's center
    # (x = 0) sits at index 2*(n//2) + n - 1 (= 2n-1 for even n, 2n-2 odd)
    t = np.arange(4 * n - 3, dtype=np.float64) - (2 * (n // 2) + n - 1)
    pre = np.exp(-1j * np.pi / n * (tana2 / 4.0) * t * t)
    c = np.pi / n / sina / 4.0
    t2 = np.arange(-(4 * n - 4), 4 * n - 3, dtype=np.float64)
    kern = np.exp(1j * c * t2 * t2)
    # sinc interpolation kernel (length 4n-5, centered)
    ts = np.arange(-(2 * n - 3), 2 * n - 2, dtype=np.float64)
    sker = np.sinc(ts / 2.0)
    L1 = 1 << int(np.ceil(np.log2(6 * n - 7)))
    L2 = 1 << int(np.ceil(np.log2(12 * n - 11)))
    sinc_spec = np.fft.fft(sker, L1)
    chirp_spec = np.fft.fft(kern, L2)
    post = pre * (np.sqrt(c / np.pi) * np.exp(-1j * (1.0 - a) * np.pi / 4.0))
    # NUMPY outputs only: jnp constants created inside one jit trace must
    # not be cached across traces (leaked-tracer hazard) — the caller
    # converts per trace, which is free (constants are baked in anyway).
    f32 = lambda z: (z.real.astype(np.float32), z.imag.astype(np.float32))
    return f32(pre), f32(post), f32(sinc_spec), f32(chirp_spec), L1, L2


def _conv_spec(re, im, spec_r, spec_i, L, lo, hi):
    """Linear convolution with a precomputed kernel spectrum: pad the
    last axis to L, pointwise-multiply in the frequency domain through
    the plan cache, return the [lo:hi] slice of the full conv output."""
    from ..plan.plan import get_plan

    p = get_plan(L, "auto")
    pad = [(0, 0)] * (re.ndim - 1) + [(0, L - re.shape[-1])]
    fr, fi = p._execute_split(jnp.pad(re, pad), jnp.pad(im, pad), -1, None)
    pr = fr * spec_r - fi * spec_i
    pi = fr * spec_i + fi * spec_r
    gr, gi = p._execute_split(pr, pi, +1, 1.0 / L)
    return gr[..., lo:hi], gi[..., lo:hi]


def _centered_fft(re, im, sign):
    """Unitary DFT (sign=-1) / IDFT (sign=+1) in the centered convention:
    out = unshift(F(shift(x))) / sqrt(N)."""
    from ..plan.plan import get_plan

    n = re.shape[-1]
    p = get_plan(n, "auto")
    s = n // 2
    re = jnp.roll(re, -s, axis=-1)
    im = jnp.roll(im, -s, axis=-1)
    # executors compute the raw DFT sums; 1/sqrt(N) makes both unitary
    fr, fi = p._execute_split(re, im, sign, n ** -0.5)
    return jnp.roll(fr, s, axis=-1), jnp.roll(fi, s, axis=-1)


def _parity(re, im):
    """Grid parity x -> -x (circular reversal keeping index 0)."""
    return (jnp.roll(jnp.flip(re, -1), 1, -1),
            jnp.roll(jnp.flip(im, -1), 1, -1))


def _interleave2(x):
    """[..., n] -> [..., 2n-1] with x at even positions, zeros between."""
    z = jnp.zeros_like(x)
    y = jnp.stack([x, z], axis=-1).reshape(*x.shape[:-1], 2 * x.shape[-1])
    return y[..., : 2 * x.shape[-1] - 1]


def _core(re, im, n, a):
    """F^a for 0.5 <= a <= 1.5 on the last axis."""
    (pre_r, pre_i), (post_r, post_i), (ss_r, ss_i), (cs_r, cs_i), L1, L2 = (
        _core_tables(n, float(a)))
    # 2x sinc upsampling (exact for the bandlimited periodic extension)
    yr, yi = _interleave2(re), _interleave2(im)
    ur, ui = _conv_spec(yr, yi, ss_r, ss_i, L1, 2 * n - 3, 4 * n - 4)
    # zero-pad to 4n-3 and chirp-premultiply
    pad = [(0, 0)] * (ur.ndim - 1) + [(n - 1, n - 1)]
    ur, ui = jnp.pad(ur, pad), jnp.pad(ui, pad)
    vr = ur * pre_r - ui * pre_i
    vi = ur * pre_i + ui * pre_r
    # chirp convolution
    wr, wi = _conv_spec(vr, vi, cs_r, cs_i, L2, 4 * n - 4, 8 * n - 7)
    # chirp post-multiply (scale + phase folded into the table)
    orr = wr * post_r - wi * post_i
    oi = wr * post_i + wi * post_r
    # decimate back to the original grid
    return orr[..., n - 1:3 * n - 2:2], oi[..., n - 1:3 * n - 2:2]


@functools.lru_cache(maxsize=64)
def _frft_impl(n: int, a4: float):
    """One jitted program per (n, a mod 4) computing F^a on the last axis
    of a split pair (leading batch dims are free).  Bounded cache: order
    sweeps (continuous a) would otherwise retain an executable per order
    forever."""
    a = a4

    @jax.jit
    def impl(re, im):
        x = (re, im)
        aa = a
        if aa == 0.0:
            return x
        if aa == 2.0:
            return _parity(*x)
        if aa == 1.0:
            return _centered_fft(*x, -1)
        if aa == 3.0:
            return _centered_fft(*x, +1)
        if aa > 2.0:
            aa -= 2.0
            x = _parity(*x)
        if aa > 1.5:
            aa -= 1.0
            x = _centered_fft(*x, -1)
        if aa < 0.5:
            aa += 1.0
            x = _centered_fft(*x, +1)
        return _core(x[0], x[1], n, aa)

    return impl


def frft(x, a: float, *, axis: int = -1):
    """Fractional Fourier transform of order `a` along `axis`.

    Returns complex64.  Additive (frft(frft(x, a), b) == frft(x, a + b))
    and unitary to roundoff on time-frequency-concentrated signals (see
    module docstring for the admissibility caveat); a=1 is the centered
    unitary DFT on the grid x_n = (n - N/2)/sqrt(N) exactly.
    """
    re, im = promote_to_split(x)
    a4 = float(np.mod(a, 4.0))
    re = jnp.moveaxis(re, axis, -1)
    im = jnp.moveaxis(im, axis, -1)
    rr, ii = _frft_impl(re.shape[-1], a4)(re, im)
    return merge(jnp.moveaxis(rr, -1, axis), jnp.moveaxis(ii, -1, axis))


def frft2(x, a, *, axes=(-2, -1)):
    """Separable 2-D fractional Fourier transform (the standard optical
    FrFT): order `a` — a scalar or an (a0, a1) pair — applied along both
    `axes`.  frft2(x, 1) is the centered unitary 2-D DFT."""
    if np.ndim(a) == 0:
        a0 = a1 = float(a)
    else:
        a0, a1 = map(float, a)
    ax0, ax1 = axes
    return frft(frft(x, a0, axis=ax0), a1, axis=ax1)


# ---------------------------------------------------------------------------
# Exactly-unitary DISCRETE FrFT (eigenvector method)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _dfrft_basis(n: int):
    """Hermite-like DFT eigenbasis (Candan-Kutay-Ozaktas): the
    eigenvectors of the Dickinson-Steiglitz tridiagonal-plus-corners S
    matrix that commutes with the DFT, split into even/odd symmetry
    subspaces (avoids degenerate-eigenvalue mixing) and ordered by
    Hermite index h (for even n the last even vector carries index n —
    the standard convention skips n-1).

    Returns (V [n, n] f32 orthonormal columns, h [n] int).  Host f64
    eigendecomposition, O(n^3) once per n (cached); the transform itself
    is two [n, n] matmuls.
    """
    k = np.arange(n)
    S = np.zeros((n, n))
    S[k, k] = 2.0 * np.cos(2 * np.pi * k / n) - 4.0
    S[k, (k + 1) % n] = 1.0
    S[k, (k - 1) % n] = 1.0
    half = n // 2
    E = []
    for j in range(half + 1):
        v = np.zeros(n)
        if j == 0 or (n % 2 == 0 and j == half):
            v[j] = 1.0
        else:
            v[j] = v[n - j] = 1.0 / np.sqrt(2.0)
        E.append(v)
    O = []
    for j in range(1, (n - 1) // 2 + 1):
        v = np.zeros(n)
        v[j] = 1.0 / np.sqrt(2.0)
        v[n - j] = -1.0 / np.sqrt(2.0)
        O.append(v)
    E = np.array(E).T
    O = np.array(O).T if O else np.zeros((n, 0))
    we, Ve = np.linalg.eigh(E.T @ S @ E)
    even_vecs = E @ Ve[:, np.argsort(-we)]
    if O.shape[1]:
        wo, Vo = np.linalg.eigh(O.T @ S @ O)
        odd_vecs = O @ Vo[:, np.argsort(-wo)]
    else:
        odd_vecs = O
    V = np.zeros((n, n))
    h = np.zeros(n, np.int64)
    ie = io = idx = 0
    for m in range(n):
        if m % 2 == 0:
            V[:, idx] = even_vecs[:, ie]
            h[idx] = m
            ie += 1
            idx += 1
        elif io < odd_vecs.shape[1]:
            V[:, idx] = odd_vecs[:, io]
            h[idx] = m
            io += 1
            idx += 1
    if idx < n:  # even n: the leftover even vector has Hermite index n
        V[:, idx] = even_vecs[:, ie]
        h[idx] = n
    return V.astype(np.float32), h


@functools.partial(jax.jit, static_argnames=("axis",))
def _dfrft_apply(re, im, V, pr, pi, *, axis):
    prec = jax.lax.Precision.HIGHEST
    re = jnp.moveaxis(re, axis, -1)
    im = jnp.moveaxis(im, axis, -1)
    ur = jnp.tensordot(re, V, axes=[[-1], [0]], precision=prec)
    ui = jnp.tensordot(im, V, axes=[[-1], [0]], precision=prec)
    vr = ur * pr - ui * pi
    vi = ur * pi + ui * pr
    yr = jnp.tensordot(vr, V, axes=[[-1], [1]], precision=prec)
    yi = jnp.tensordot(vi, V, axes=[[-1], [1]], precision=prec)
    return jnp.moveaxis(yr, -1, axis), jnp.moveaxis(yi, -1, axis)


def dfrft(x, a: float, *, axis: int = -1):
    """EXACTLY unitary discrete fractional Fourier transform of order
    `a` (Candan-Kutay-Ozaktas eigenvector method).

    F^a = V diag(e^{-i pi a h / 2}) V^T over the Hermite-ordered DFT
    eigenbasis: additive, unitary, and invertible to roundoff for EVERY
    input (including broadband noise — the admissibility caveat of the
    chirp-based `frft` does not apply), with a=1 exactly the unitary DFT
    and a=2 exactly circular parity.  Cost: one O(n^3) host
    eigendecomposition per n (cached), then two [n, n] matmuls per
    call — prefer `frft` (O(n log n)) for long admissible signals.
    dfrft and frft realize different fractional operators away from
    integer orders (different eigenvalue assignments); both reduce to
    the same integer-order transforms up to grid convention.
    """
    re, im = promote_to_split(x)
    n = re.shape[axis]
    V, h = _dfrft_basis(n)
    ph = -0.5 * np.pi * float(a) * h
    pr = jnp.asarray(np.cos(ph).astype(np.float32))
    pi_ = jnp.asarray(np.sin(ph).astype(np.float32))
    yr, yi = _dfrft_apply(re, im, jnp.asarray(V), pr, pi_, axis=axis)
    return merge(yr, yi)
