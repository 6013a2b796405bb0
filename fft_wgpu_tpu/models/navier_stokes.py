"""Pseudo-spectral 2-D Navier-Stokes (vorticity form) on the FFT stack.

A production-style spectral solver exercising the full R2C/C2R 2-D
pipeline under `lax.scan` (everything in ONE jitted program — the
reference's "record many transforms into one submission" pattern,
fft_wgpu src/examples/basic_inverse2.rs:85-92, taken to its
conclusion).  The reference ships no models (SURVEY §1); this module is
part of the framework's model family alongside models/spectral.py.

Method: vorticity w on a [n, n] periodic grid,

    dw/dt + u . grad(w) = nu * lap(w) + f

integrated in spectral space with the standard split: exact integrating
factor for the viscous term, RK2 (Heun) for the advection term evaluated
pseudo-spectrally with 2/3-rule dealiasing.  The velocity comes from the
streamfunction: u = (d psi/dy, -d psi/dx), psi_hat = w_hat / k^2.

State is carried as the SPLIT (re, im) half-spectrum pair — complex
never crosses the step boundary, matching the framework invariant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rfft import irfft_last_split, rfft_last_split

__all__ = ["NS2DPlan", "ns2d_init", "ns2d_step", "ns2d_rollout", "taylor_green_vorticity"]


def _wavenumbers(n: int):
    """(kx[n,1], ky[1, n//2+1], ksq, dealias mask) for an rfft2 layout
    with axis 0 full-spectrum and axis 1 half-spectrum."""
    kx = np.fft.fftfreq(n, 1.0 / n).astype(np.float32)[:, None]
    ky = np.abs(np.fft.rfftfreq(n, 1.0 / n).astype(np.float32))[None, :]
    ksq = kx * kx + ky * ky
    cut = n / 3.0
    mask = ((np.abs(kx) <= cut) & (ky <= cut)).astype(np.float32)
    return (jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(ksq),
            jnp.asarray(mask))


def _rfft2_split(x):
    """Real [.., n, n] -> split half spectrum [.., n, n//2+1] (rows R2C
    then complex FFT down axis -2 through the plan layer)."""
    from ..plan.plan import get_plan

    Xr, Xi = rfft_last_split(x, None)
    p = get_plan(Xr.shape[-2], "auto")
    return p._execute_split_axis(Xr, Xi, -1, None, -2)


def _irfft2_split(Xr, Xi, n):
    """Split half spectrum -> real [.., n, n] (inverse axis -2, then C2R
    rows with the full 1/n^2 folded across the two passes)."""
    from ..plan.plan import get_plan

    p = get_plan(Xr.shape[-2], "auto")
    Xr, Xi = p._execute_split_axis(Xr, Xi, +1, 1.0 / n, -2)
    return irfft_last_split(Xr, Xi, n, 1.0 / n)


class NS2DPlan:
    """Immutable stepper config (plan-object semantics: build once with
    ns2d_init, replay many times).  Compiled rollouts are cached on a
    PRIVATE attribute, never inside the user-visible constants — and the
    config must not be mutated after construction (rebuild instead)."""

    def __init__(self, consts):
        self._consts = consts
        self._jit_cache = {}

    def __getitem__(self, key):
        return self._consts[key]


def ns2d_init(n: int, nu: float, dt: float):
    """Precompute the stepper's spectral constants (a plan-like object)."""
    kx, ky, ksq, mask = _wavenumbers(n)
    ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
    visc = jnp.exp(-nu * ksq * dt)  # exact viscous integrating factor
    return NS2DPlan({
        "n": n, "dt": dt, "kx": kx, "ky": ky, "ksq_safe": ksq_safe,
        "mask": mask, "visc": visc,
    })


def _nonlinear(c, wr, wi):
    """N(w)_hat = -(u . grad w)_hat, dealiased, from split w_hat."""
    n = c["n"]
    kx, ky, ksq = c["kx"], c["ky"], c["ksq_safe"]
    # psi_hat = w_hat / k^2; u = d psi/dy, v = -d psi/dx
    pr, pi = wr / ksq, wi / ksq
    # i*k multiply in split form: (r, i) -> (-k*i, k*r)
    ur, ui = -ky * pi, ky * pr          # u_hat = i ky psi_hat
    vr, vi = kx * pi, -kx * pr           # v_hat = -i kx psi_hat
    wxr, wxi = -kx * wi, kx * wr         # dw/dx_hat
    wyr, wyi = -ky * wi, ky * wr         # dw/dy_hat
    u = _irfft2_split(ur, ui, n)
    v = _irfft2_split(vr, vi, n)
    wx = _irfft2_split(wxr, wxi, n)
    wy = _irfft2_split(wyr, wyi, n)
    adv = u * wx + v * wy
    ar, ai = _rfft2_split(adv)
    m = c["mask"]
    return -ar * m, -ai * m


def ns2d_step(c, wr, wi):
    """One Heun (RK2) step with exact viscous factor, split-spectral state."""
    n1r, n1i = _nonlinear(c, wr, wi)
    dt = c["dt"]
    # predictor: full step of N, full viscous decay
    pr = (wr + dt * n1r) * c["visc"]
    pi = (wi + dt * n1i) * c["visc"]
    n2r, n2i = _nonlinear(c, pr, pi)
    # corrector: average the slopes, each decayed to t+dt
    wr2 = wr * c["visc"] + 0.5 * dt * (n1r * c["visc"] + n2r)
    wi2 = wi * c["visc"] + 0.5 * dt * (n1i * c["visc"] + n2i)
    return wr2, wi2


def ns2d_rollout(c, w0, steps: int):
    """Integrate real vorticity w0 [n, n] for `steps` steps inside one
    jitted lax.scan; returns the final real vorticity field.

    The jitted program is cached on the plan per step count, so repeated
    rollouts with the same config replay without retracing/recompiling
    (the plan layer's _jit_cache pattern)."""
    cache = c._jit_cache
    run = cache.get(steps)
    if run is None:

        @jax.jit
        def run(w0):
            wr, wi = _rfft2_split(w0)
            m = c["mask"]
            wr, wi = wr * m, wi * m

            def body(carry, _):
                return ns2d_step(c, *carry), None

            (wr, wi), _ = jax.lax.scan(body, (wr, wi), None, length=steps)
            return _irfft2_split(wr, wi, c["n"])

        cache[steps] = run
    return run(w0)


def taylor_green_vorticity(n: int, k: int = 1):
    """Taylor-Green vortex initial vorticity w = 2k cos(kx) cos(ky) on
    [0, 2pi)^2 — an exact decaying solution of the unforced equations:
    w(t) = w(0) * exp(-2 k^2 nu t) (its nonlinear term vanishes)."""
    xs = np.arange(n, dtype=np.float32) * (2.0 * np.pi / n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    return jnp.asarray(2.0 * k * np.cos(k * X) * np.cos(k * Y))
