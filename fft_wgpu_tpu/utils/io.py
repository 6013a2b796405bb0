"""Host<->device transfer helpers and the persistent compile cache.

The transfer helpers move complex data across the boundary as planar re/im
float32, split and merged on the host in one threaded pass of the native
core — the analogue of the reference's staging-buffer readback
(fft_wgpu examples/basic.rs:84-122), done once per result instead of per
iteration.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["device_get_complex", "device_put_complex", "enable_persistent_compilation_cache"]


@jax.jit
def _split_for_host(z):
    return jnp.real(z).astype(jnp.float32), jnp.imag(z).astype(jnp.float32)


def device_get_complex(z) -> np.ndarray:
    """Fetch a (possibly complex) device array to host numpy, transferring
    planar float32."""
    z = jnp.asarray(z)
    if not jnp.iscomplexobj(z):
        return np.asarray(z)
    re, im = _split_for_host(z)
    from .native import host_merge_complex

    out = host_merge_complex(np.asarray(re), np.asarray(im))
    if out is not None:  # one-pass threaded C++ interleave
        return out
    return np.asarray(re) + 1j * np.asarray(im)


def device_put_complex(x: np.ndarray, device=None):
    """Host complex numpy -> device complex64 array, staged as planar f32."""
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        return jax.device_put(x, device)
    from .native import host_split_complex

    pair = host_split_complex(x)
    if pair is None:
        pair = (np.ascontiguousarray(x.real, np.float32),
                np.ascontiguousarray(x.imag, np.float32))
    re = jax.device_put(pair[0], device)
    im = jax.device_put(pair[1], device)
    return jax.jit(jax.lax.complex)(re, im)


# <checkout>/.jax_cache (listed in .gitignore): a fixed path, because the
# path is part of the cache key
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_compilation_cache() -> str:
    """Enable JAX's on-disk compilation cache for plan executables.

    Uses `JAX_COMPILATION_CACHE_DIR` when it is set (and no other
    directory); otherwise the fixed in-checkout directory `.jax_cache/`.
    Plan warmup after the first process start then skips compilation —
    the serving-deployment analogue of shipping precompiled pipelines.
    Returns the directory.
    """
    p = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR
    os.makedirs(p, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", p)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return p
