"""Config-keyed jit cache for convenience-API entry points.

The scipy-parity functions (welch/stft/fftconvolve/...) build a closure
per call and jit it; without caching every call re-traces (host time
spent even when the persistent XLA compile cache hits).  `cached_jit(key, impl)` reuses the traced executable for
hashable configs — the plan layer's executable cache generalized to the
functional surface.  Unhashable key parts (array windows, callables)
fall back to a fresh jit safely.
"""

from __future__ import annotations

import jax

__all__ = ["cached_call", "cached_jit", "window_key", "shape_key"]

_CACHE: dict = {}


def cached_call(key, impl, *args):
    """cached_jit(key, impl)(*args) — but when called INSIDE an active
    trace (any arg is a Tracer), inline impl instead: a cached closure
    would capture constants belonging to the enclosing (soon dead)
    trace and leak them into later calls (UnexpectedTracerError)."""
    if any(isinstance(a, jax.core.Tracer) for a in args):
        return impl(*args)
    return cached_jit(key, impl)(*args)


def cached_jit(key, impl):
    """jit(impl) memoized on `key` (None or unhashable key: no cache)."""
    try:
        hash(key)
    except TypeError:
        key = None
    if key is None:
        return jax.jit(impl)
    fn = _CACHE.get(key)
    if fn is None:
        if len(_CACHE) > 256:  # unbounded-growth guard
            _CACHE.clear()
        fn = jax.jit(impl)
        _CACHE[key] = fn
    return fn


def window_key(window):
    """Hashable identity of a window spec, or None (array/callable)."""
    if window is None or isinstance(window, str):
        return window
    if isinstance(window, tuple) and all(
            isinstance(v, (str, int, float)) for v in window):
        return window
    return None


def shape_key(a):
    return None if a is None else (tuple(a.shape), str(a.dtype))
