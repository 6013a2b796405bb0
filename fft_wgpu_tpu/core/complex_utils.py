"""Split real/imag complex representation helpers.

The split-domain executors carry complex data as a pair of real arrays
``(re, im)`` and expose a ``complex64`` facade at the public API boundary.

This mirrors the reference's interleaved ``Complex { real, imag }`` data model
(fft_wgpu src/lib.rs:10-27) but in planar (split) form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["split", "merge", "promote_to_split"]


@jax.jit
def _split_device(x):
    return jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)


def split(x):
    """complex array -> (re, im) pair of real float32 arrays.

    Host numpy complex input is split on the host (one threaded pass in the
    native core); device arrays are split under jit.
    """
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        from ..utils.native import host_split_complex

        pair = host_split_complex(x)  # one-pass threaded C++ deinterleave
        if pair is None:  # no native core: two-pass numpy fallback
            pair = (np.ascontiguousarray(x.real, np.float32),
                    np.ascontiguousarray(x.imag, np.float32))
        return jnp.asarray(pair[0]), jnp.asarray(pair[1])
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return _split_device(x)
    x = x.astype(jnp.float32)
    return x, jnp.zeros_like(x)


@jax.jit
def _merge_device(re, im):
    return jax.lax.complex(re, im)


def merge(re, im):
    """(re, im) pair -> complex64 array (explicit, x64-config-proof).

    Jitted; under an enclosing jit this inlines for free.
    """
    return _merge_device(jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32))


def promote_to_split(x):
    """Accept complex/real jnp or numpy input, return (re, im) float32 pair.

    Host numpy input goes straight to :func:`split`, which splits complex
    on the host.
    """
    if isinstance(x, (tuple, list)) and len(x) == 2:
        re, im = x
        return jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32)
    return split(x)
