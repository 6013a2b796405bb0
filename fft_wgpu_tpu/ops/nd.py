"""Multi-dimensional C2C transforms (row-column decomposition).

The reference is strictly 1-D (SURVEY §1); 2-D/3-D are new capabilities
required by BASELINE.json config 4/5.  On the plan layer's "auto" route the
transform axes go to XLA's FFT up to three at a time (`jax.lax.fft` with
several `fft_lengths`); any other executor runs separably, one axis at a
time.  The whole N-D pipeline traces into one jitted program, so XLA owns
the inter-axis transposes.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

from ..core.complex_utils import merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE

__all__ = ["fft2", "ifft2", "fftn", "ifftn", "fftn_split"]


def _norm_axes(ndim, s, axes):
    if axes is None:
        if s is not None and len(s) > ndim:
            # numpy maps s to the LAST len(s) axes; more entries than
            # dims is an out-of-range axis there, not a silent wrap
            raise ValueError(
                f"shape requires {len(s)} axes but input has {ndim} "
                f"dimensions")
        axes = list(range(ndim)) if s is None else list(range(ndim - len(s), ndim))
    for a in axes:
        if not -ndim <= a < ndim:
            raise ValueError(
                f"axis {a} is out of bounds for array of dimension {ndim}")
    axes = [a % ndim for a in axes]
    if s is None:
        s = [None] * len(axes)
    if len(s) != len(axes):
        raise ValueError("s and axes must have the same length")
    return list(s), axes


def _lax_chunks(axes):
    """Group transform axes, from the last, into runs of up to 3 distinct
    axes (one `lax.fft` call each)."""
    chunks, cur = [], []
    for ax in reversed(axes):
        if len(cur) == 3 or ax in cur:
            chunks.append(cur)
            cur = []
        cur.insert(0, ax)
    chunks.append(cur)
    return chunks


def fftn_split(re, im, axes, sign, scale, executor="auto"):
    """Apply the transform along each axis; scale applied once at the end."""
    from ..plan.plan import get_plan, lax_fft

    nd = re.ndim
    axes = [a % nd for a in axes]
    if executor in ("auto", "lax") and axes:
        z = lax.complex(re, im)
        chunks = _lax_chunks(axes)
        for i, chunk in enumerate(chunks):
            back = list(range(nd - len(chunk), nd))
            z = jnp.moveaxis(z, chunk, back)
            z = lax_fft(z, sign, scale if i == len(chunks) - 1 else None,
                        ndims=len(chunk))
            z = jnp.moveaxis(z, back, chunk)
        return jnp.real(z), jnp.imag(z)

    for ax in axes:
        p = get_plan(re.shape[ax], executor)
        re, im = p._execute_split_axis(re, im, sign, None, ax)
    if scale is not None and scale != 1.0:
        s = jnp.float32(scale)
        re, im = re * s, im * s
    return re, im


def _run_nd(x, s, axes, sign, norm, executor):
    re, im = promote_to_split(x)
    s, axes = _norm_axes(re.ndim, s, axes)
    # numpy semantics: s trims/pads each axis
    for size, ax in zip(s, axes):
        if size is not None and re.shape[ax] != size:
            cur = re.shape[ax]
            if cur > size:
                idx = [slice(None)] * re.ndim
                idx[ax] = slice(0, size)
                re, im = re[tuple(idx)], im[tuple(idx)]
            else:
                pad = [(0, 0)] * re.ndim
                pad[ax] = (0, size - cur)
                re, im = jnp.pad(re, pad), jnp.pad(im, pad)

    total = math.prod(re.shape[a] for a in axes)
    if norm in (None, "backward"):
        scale = None if sign == FORWARD else 1.0 / total
    elif norm == "ortho":
        scale = total**-0.5
    elif norm == "forward":
        scale = 1.0 / total if sign == FORWARD else None
    else:
        raise ValueError(f"invalid norm {norm!r}")

    from ..utils.jit_cache import cached_call, shape_key

    key = ("nd", jax.default_backend(), shape_key(re), tuple(axes),
           sign, scale, executor)
    return cached_call(
        key,
        lambda r, i: merge(*fftn_split(r, i, tuple(axes), sign, scale,
                                       executor)),
        re, im)


def fftn(x, s=None, axes=None, norm=None, *, executor: str = "auto"):
    """N-D forward C2C FFT (numpy.fft.fftn semantics)."""
    return _run_nd(x, s, axes, FORWARD, norm, executor)


def ifftn(x, s=None, axes=None, norm=None, *, executor: str = "auto"):
    """N-D inverse C2C FFT (numpy.fft.ifftn semantics)."""
    return _run_nd(x, s, axes, INVERSE, norm, executor)


def fft2(x, s=None, axes=(-2, -1), norm=None, *, executor: str = "auto"):
    """2-D forward FFT over `axes` (default last two)."""
    return _run_nd(x, s, list(axes), FORWARD, norm, executor)


def ifft2(x, s=None, axes=(-2, -1), norm=None, *, executor: str = "auto"):
    """2-D inverse FFT over `axes` (default last two)."""
    return _run_nd(x, s, list(axes), INVERSE, norm, executor)
