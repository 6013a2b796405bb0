"""Kernel validation / sanitizer harness (SURVEY §5 race-detection row).

The reference relies on WGSL implicit bounds clamping and per-stage
`workgroupBarrier` for correctness (fft4.wgsl:34,93); our equivalents:

* `validate_kernel(n)` — run the plan layer's "auto" executor against the
  f64 naive-DFT oracle on whatever device JAX has.
* `check_finite` — checkify-style NaN/Inf guard around any executor.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.reference import naive_dft

__all__ = ["validate_kernel", "check_finite"]


def validate_kernel(n: int, batch: int = 4, sign: int = -1, seed: int = 0,
                    tol: float = 1e-5) -> float:
    """The "auto" executor vs the f64 naive DFT; returns rel-L2 error.

    Raises AssertionError above `tol`.
    """
    from ..plan.plan import get_plan

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n)))
    re = jnp.asarray(x.real, jnp.float32)
    im = jnp.asarray(x.imag, jnp.float32)
    rr, ii = get_plan(n)._execute_split(re, im, sign, None)
    got = np.asarray(rr) + 1j * np.asarray(ii)
    want = naive_dft(x) if sign == -1 else naive_dft(x.conj()).conj()
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert err < tol, f"kernel validation failed at n={n}: rel-L2 {err:.3e}"
    return err


def check_finite(re, im, what: str = "fft"):
    """checkify guard: callers wrap their executor with
    `jax.experimental.checkify.checkify` and this check reports NaN/Inf in
    the pair with a useful label.  Returns the inputs for chaining."""
    from jax.experimental import checkify

    checkify.check(
        jnp.isfinite(re).all() & jnp.isfinite(im).all(),
        f"non-finite values in {what}",
    )
    return re, im
