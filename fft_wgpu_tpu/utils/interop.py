"""torch <-> jax interop for migrating torch.fft call sites.

The reference framework's would-be users often arrive from torch.fft
pipelines; these helpers move tensors across with the framework's
complex-boundary discipline (complex is staged as planar float32 via
utils/io.py).

Real tensors ride DLPack when possible (zero-copy on CPU torch -> CPU
jax; a single H2D otherwise); complex tensors are split on the host
(threaded C++ codec when built) and assembled on device.

No torch import happens unless these functions are called, so the
package has no hard torch dependency.
"""

from __future__ import annotations

import numpy as np

__all__ = ["from_torch", "to_torch"]


def _torch():
    try:
        import torch
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "from_torch/to_torch require torch (not installed)") from e
    return torch


def from_torch(t, device=None):
    """torch.Tensor -> jax array on `device`.

    Complex tensors cross the boundary as planar f32 and come back as a
    device complex64 array (ready for any framework entry point); real
    tensors transfer directly (DLPack zero-copy where backends allow)."""
    torch = _torch()
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected torch.Tensor, got {type(t).__name__}")
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.is_complex():
        from .io import device_put_complex

        return device_put_complex(t.numpy(), device)
    import jax

    try:
        arr = jax.dlpack.from_dlpack(t.contiguous())
        if device is not None:
            arr = jax.device_put(arr, device)
        return arr
    except Exception:
        return jax.device_put(np.asarray(t.contiguous()), device)


def to_torch(x):
    """jax array (or numpy) -> torch CPU tensor.

    Complex device arrays are fetched as planar f32 and re-interleaved on
    the host (device_get_complex), so this works on runtimes that cannot
    transfer complex; real arrays fetch directly."""
    torch = _torch()
    from .io import device_get_complex

    host = device_get_complex(x)  # handles real passthrough + planar fetch
    return torch.from_numpy(np.ascontiguousarray(host))
