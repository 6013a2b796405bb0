"""Global dot-precision control for the DFT-by-matmul executors.

The matmul recursion (executor ``"xla"``, ops/stockham.py) and the direct
DFT (``"direct"``) compute each DFT stage as a constant-matrix matmul.
XLA's FFT (executor ``"lax"``, what ``"auto"`` resolves to) has no
matmuls and is not affected.

* ``"accurate"`` (default): `Precision.HIGHEST`, full float32 products;
  transforms are checked at rel-L2 <= 1e-5.
* ``"fast"``: `Precision.DEFAULT`.  On an NVIDIA H100 an f32 matmul then
  runs on the tensor cores in TF32, which keeps 10 mantissa bits (unit
  roundoff 2**-11 ~ 4.9e-4), so a transform's rel-L2 error is of order
  1e-3; it is checked at <= 5e-3 (chip_smoke.py prints the measured
  value).  On the CPU DEFAULT is full float32 and "fast" changes nothing.

Reference anchor: the reference has no precision control at all (f32
WGSL throughout, fft_wgpu src/kernel/fft.wgsl).
"""

from __future__ import annotations

from contextlib import contextmanager

import jax

__all__ = ["set_dot_precision", "get_dot_precision", "dot_precision"]

_MODES = {
    "accurate": jax.lax.Precision.HIGHEST,  # full f32 products
    "fast": jax.lax.Precision.DEFAULT,      # TF32 on an H100
}

# rel-L2 bound each mode is checked at (see the module docstring)
TOLERANCE = {"accurate": 1e-5, "fast": 5e-3}
_current = "accurate"


def set_dot_precision(mode: str) -> None:
    """Set the DFT-matmul precision for ALL subsequent transforms.

    mode: "accurate" (default; Precision.HIGHEST) or "fast"
    (Precision.DEFAULT: TF32 on an H100).

    Takes effect for everything traced after the call: already-compiled
    executables are flushed (jax.clear_caches + the plan cache), so
    switching mid-process retraces — call it once up front in serving
    code.
    """
    global _current
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got "
                         f"{mode!r}")
    from ..ops import stockham as st

    st._DOT_PREC = _MODES[mode]
    _current = mode
    jax.clear_caches()
    from ..plan.plan import get_plan

    get_plan.cache_clear()


def get_dot_precision() -> str:
    """Current mode name ("accurate" | "fast")."""
    return _current


@contextmanager
def dot_precision(mode: str):
    """Context manager form of set_dot_precision (restores on exit).

    Note the cache flush on entry AND exit: use for whole workloads,
    not per-call toggling.
    """
    prev = _current
    set_dot_precision(mode)
    try:
        yield
    finally:
        set_dot_precision(prev)
