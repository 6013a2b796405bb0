"""scipy.fft backend: route scipy.fft calls through fft_wgpu_tpu.

scipy.fft dispatches through uarray, so any object exposing
``__ua_domain__``/``__ua_function__`` can serve as a backend — no scipy
import is needed to define one.  Usage::

    import scipy.fft as sf
    import fft_wgpu_tpu.scipy_backend as ftt_fft

    with sf.set_backend(ftt_fft):          # scoped
        X = sf.fft(x)
    ftt_fft.install()                      # or process-global

Existing scipy.fft call sites then execute on the device unchanged.
Outputs are returned as host numpy (complex fetched via the planar-f32
transfer helpers — some runtimes cannot move complex across the
host<->device boundary).  This is the eager/interop path; for
performance-critical code use the native API under one jit
(`fft_wgpu_tpu.fft` etc.), which keeps data device-resident.

Dispatch rules:
- ``workers``/``plan``/``overwrite_x`` are advisory in scipy and ignored
  here (XLA owns scheduling; plans are cached internally by the Plan
  layer).
- Any call the framework cannot express (e.g. ``orthogonalize=`` DCT
  variants) returns ``NotImplemented`` so scipy falls back to pocketfft
  (unless the user passed ``only=True``).

Replaces nothing in the reference (fft_wgpu has no host-library interop
layer); completeness feature for scipy migrators.
"""

from __future__ import annotations

__ua_domain__ = "numpy.scipy.fft"

_ADVISORY_KWARGS = ("overwrite_x", "workers", "plan")


def _to_host(out):
    """Device output -> host numpy, complex via planar transfer."""
    from .utils.io import device_get_complex

    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    return device_get_complex(out)


def __ua_function__(method, args, kwargs):
    import inspect

    import fft_wgpu_tpu as ftt

    fn = getattr(ftt, method.__name__, None)
    if fn is None:
        return NotImplemented
    kw = dict(kwargs)
    for k in _ADVISORY_KWARGS:
        kw.pop(k, None)
    try:
        # signature check BEFORE calling: a scipy kwarg this framework
        # doesn't express (e.g. orthogonalize=) falls back to pocketfft,
        # while genuine execution errors propagate instead of being
        # silently masked by the fallback.
        inspect.signature(fn).bind(*args, **kw)
    except TypeError:
        return NotImplemented
    return _to_host(fn(*args, **kw))


def install() -> None:
    """Register this module as scipy.fft's global backend (with pocketfft
    fallback for anything returning NotImplemented)."""
    import scipy.fft as sf

    import fft_wgpu_tpu.scipy_backend as me

    sf.register_backend(me)
    sf.set_global_backend(me, only=False, try_last=False)
