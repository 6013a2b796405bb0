"""Mixed-radix FFT by DFT matmuls in pure jnp (executor ``"xla"``).

A redesign of the reference's WGSL butterfly pipeline
(fft_wgpu src/kernel/fft4.wgsl, ifft.wgsl): instead of radix-2
scalar-thread butterflies, the transform is expressed as a recursive
four-step (Cooley-Tukey) decomposition whose base cases are *direct DFT
matmuls*.  Like the reference's Stockham
autosort formulation (fft4.wgsl:61-70) the output is in natural order with
no bit-reversal pass — the reordering is absorbed into the final
transpose-flatten of each decomposition level.

Math (one level), for n = n1*n2, x row-major viewed as A[n1, n2]:
    B[k1, n2] = DFT_n1 over axis 0 of A
    C[k1, n2] = B * tw,  tw[k1, n2] = exp(sign*2pi*i*k1*n2/n)
    D[k1, k2] = DFT_n2 over axis 1 of C
    X[k1 + n1*k2] = D[k1, k2]    (i.e. flatten of D transposed)

Everything operates on split (re, im) float32 pairs; all matmuls request
float32 accumulation.  The transform axis is always the last one.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import factor as _factor
from ..core import twiddle as _tw

__all__ = ["fft_last_axis", "apply_scale"]

# Precision for the DFT matmuls.  HIGHEST = full float32 products (on a GPU
# DEFAULT may run as TF32, ~1e-3 relative); HIGHEST is needed to hit the
# 1e-5 relative-L2 oracle bar (reference tolerance:
# examples/basic_inverse.rs:249-253).  utils/precision.py switches it.
_DOT_PREC = jax.lax.Precision.HIGHEST


def _const(np_pair):
    wr, wi = np_pair
    return jnp.asarray(wr), jnp.asarray(wi)


def _cmatmul(ar, ai, wr, wi):
    """(ar + i*ai) @ (wr + i*wi) with f32 accumulation."""
    mm = partial(jnp.matmul, precision=_DOT_PREC)
    return (
        mm(ar, wr) - mm(ai, wi),
        mm(ar, wi) + mm(ai, wr),
    )


def _dft_direct(re, im, sign):
    """Direct DFT over the last axis via one (complex) matmul: y = x @ W."""
    n = re.shape[-1]
    wr, wi = _const(_tw.dft_matrix_np(n, sign))
    return _cmatmul(re, im, wr, wi)


def fft_last_axis(re, im, sign):
    """Mixed-radix DFT over the last axis of a split (re, im) pair."""
    n = re.shape[-1]
    if n == 1:
        return re, im
    if n <= _factor.MAX_DIRECT:
        return _dft_direct(re, im, sign)
    if not _factor.is_smooth(n):
        from . import bluestein

        if n >= bluestein.BLUESTEIN_MIN:
            # large prime factors: chirp-z via two power-of-two FFTs
            return bluestein.fft_bluestein_split(re, im, sign)
        return _dft_direct(re, im, sign)

    n1, n2 = _factor.balanced_split(n)
    lead = re.shape[:-1]
    re = re.reshape(*lead, n1, n2)
    im = im.reshape(*lead, n1, n2)

    # DFT over n1 (axis -2): transpose so it becomes the last axis.
    ar = jnp.swapaxes(re, -1, -2)  # [..., n2, n1]
    ai = jnp.swapaxes(im, -1, -2)
    br, bi = fft_last_axis(ar, ai, sign)  # B^T[n2, k1]

    # Twiddle in the transposed layout: tw^T[n2, k1].
    twr, twi = _const(_tw.twiddle_np(n1, n2, sign, transposed=True))
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr

    # Back to [..., k1, n2]; DFT over n2 (last axis).
    cr = jnp.swapaxes(cr, -1, -2)
    ci = jnp.swapaxes(ci, -1, -2)
    dr, di = fft_last_axis(cr, ci, sign)  # D[k1, k2]

    # Natural-order output: X viewed as [k2, k1] and flattened.
    dr = jnp.swapaxes(dr, -1, -2).reshape(*lead, n)
    di = jnp.swapaxes(di, -1, -2).reshape(*lead, n)
    return dr, di


def apply_scale(re, im, scale):
    if scale is None or scale == 1.0:
        return re, im
    s = jnp.float32(scale)
    return re * s, im * s
