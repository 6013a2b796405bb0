"""Opt-in jax.numpy.fft acceleration: route ``jnp.fft.*`` through this
framework's kernels.

Calls then run through the framework's plan layer (which itself calls
`jax.lax.fft`, never `jnp.fft`, so routing does not recurse).  Usage::

    import fft_wgpu_tpu.jnp_backend as jb

    jb.install()          # process-global: jnp.fft.fft etc. now route here
    jb.uninstall()        # restore stock jax.numpy.fft

    with jb.accelerated():  # scoped
        X = jnp.fft.fft(x)

Works inside user ``jax.jit`` traces (the framework's internal jits
inline) and under ``jax.grad`` (the transforms differentiate through
`lax.fft`'s own transpose rule).  Per-call fallback to
stock jnp.fft when the input is 64-bit (the framework is f32-native) or
the call uses a signature the framework doesn't express.

The reference has no host-library interop layer (it is a bare Rust/WGSL
library — SURVEY §2); this and scipy_backend are completeness features
for migrating JAX/scipy call sites wholesale.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np

_FUNCS = (
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft",
)

_originals: dict[str, object] = {}
_install_count = 0  # nesting refcount: uninstall only at zero


def _dtype_of(a):
    dt = getattr(a, "dtype", None)
    if dt is not None:
        return np.dtype(dt)
    # python scalars / sequences: host-side inspection only (never
    # jnp.asarray here — a host complex list would be a complex H2D)
    return np.asarray(a).dtype


def _wrap(name, ours, orig):
    @functools.wraps(orig)
    def accelerated_fn(a, *args, **kwargs):
        dt = _dtype_of(a)
        if dt.itemsize >= 8 and dt.kind in "fc":
            return orig(a, *args, **kwargs)  # f64/c128: stay in stock jnp
        try:
            return ours(a, *args, **kwargs)
        except TypeError:
            # signature the framework doesn't express — stock fallback
            return orig(a, *args, **kwargs)

    accelerated_fn.__wrapped_by_fft_wgpu_tpu__ = True
    return accelerated_fn


def install() -> None:
    """Patch jax.numpy.fft (and jax.numpy.fft-as-module call sites) so the
    listed transforms route through fft_wgpu_tpu.  Nestable: each install()
    must be balanced by one uninstall(); the patch is removed only when
    the count reaches zero (so an inner accelerated() block cannot strip
    an outer install())."""
    global _install_count
    import jax.numpy as jnp

    import fft_wgpu_tpu as ftt

    _install_count += 1
    for name in _FUNCS:
        cur = getattr(jnp.fft, name)
        if getattr(cur, "__wrapped_by_fft_wgpu_tpu__", False):
            continue  # already installed
        _originals[name] = cur
        setattr(jnp.fft, name, _wrap(name, getattr(ftt, name), cur))


def uninstall() -> None:
    """Balance one install(); restore stock jax.numpy.fft at zero."""
    global _install_count
    import jax.numpy as jnp

    if _install_count == 0:
        return
    _install_count -= 1
    if _install_count > 0:
        return
    for name, orig in list(_originals.items()):
        setattr(jnp.fft, name, orig)
        del _originals[name]


@contextlib.contextmanager
def accelerated():
    """Scoped install()/uninstall() (exception-safe)."""
    install()
    try:
        yield
    finally:
        uninstall()
