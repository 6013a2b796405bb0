"""Large-N 1-D FFT via four-step (Bailey) decomposition (executor
``"fourstep"``).

The reference streams butterfly stages through global memory one radix-2
stage at a time (log2(n) dispatches — processor.rs:327-330, SURVEY §3.2).
Four-step does the same thing in two *large* strides instead of log2(n)
small ones: n = n1 * n2, batched sub-FFTs over each factor (each through
the plan layer's "auto" route), an inter-factor twiddle, and an
XLA-scheduled corner turn:

    view x as A[n1, n2]
    1. B  = FFT_n1 over axis -2
    2. C  = B * tw[k1, n2]             (f64-generated twiddle plane)
    3. D  = FFT_n2 over axis -1        (output scale folded here)
    4. X[k1 + n1*k2] = D[k1, k2]       (transpose-flatten)
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import factor as _factor
from ..core import twiddle as _tw

__all__ = ["fft_last_axis", "choose_factors"]


def choose_factors(n: int) -> tuple[int, int]:
    """Split n = n1 * n2, both factors as close to sqrt(n) as possible."""
    if n & (n - 1) == 0:  # power of two
        e = n.bit_length() - 1
        e1 = e // 2
        return 1 << e1, 1 << (e - e1)
    return _factor.balanced_split(n)


def fft_last_axis(re, im, sign, scale=None):
    """Four-step FFT over the last axis of a split (re, im) pair."""
    from ..plan.plan import get_plan

    n = re.shape[-1]
    n1, n2 = choose_factors(n)
    if n1 == 1:  # prime / unsplittable: delegate to the general executor
        from . import stockham

        re, im = stockham.fft_last_axis(re, im, sign)
        return stockham.apply_scale(re, im, scale)

    lead = re.shape[:-1]
    re = re.reshape(*lead, n1, n2)
    im = im.reshape(*lead, n1, n2)

    # 1. FFT over n1 along axis -2
    p1 = get_plan(n1, "auto")
    br, bi = p1._execute_split_axis(re, im, sign, None, -2)

    # 2+3+4. twiddle, row FFT over n2, corner-turn flatten
    twr, twi = _tw.twiddle_np(n1, n2, sign)
    twr = jnp.asarray(twr)
    twi = jnp.asarray(twi)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr

    p2 = get_plan(n2, "auto")
    dr, di = p2._execute_split(cr, ci, sign, scale)

    dr = jnp.swapaxes(dr, -1, -2).reshape(*lead, n)
    di = jnp.swapaxes(di, -1, -2).reshape(*lead, n)
    return dr, di
