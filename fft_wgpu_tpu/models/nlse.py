"""Split-step Fourier integrator for the nonlinear Schrodinger equation
(and the Gross-Pitaevskii equation with an external potential):

    i psi_t + (1/2) laplacian(psi) + g |psi|^2 psi - V(x) psi = 0

on a periodic box, 1-D or 2-D.  Strang splitting: the nonlinear/potential
phase rotation is EXACT (|psi| is invariant under it), the linear step is
exact in Fourier space (multiply by exp(-i |k|^2 dt / 2)) — the canonical
pseudo-spectral method for dispersive PDE, O(dt^2) in time and spectrally
accurate in space.

Design: state is the SPLIT (re, im) complex field; each rollout is
ONE jitted lax.scan over steps (CLAUDE.md: no eager chains) riding the
batched C2C transforms; phase tables exp(-i k^2 dt/2) are f64-generated
on the host and cast once, like every trig table in this repo.  The
reference ships no models (SURVEY §1); this extends the model family
(FNO, Navier-Stokes 2-D/3-D, Burgers, KS, Poisson) with the standard
dispersive-PDE workload.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.twiddle import FORWARD, INVERSE
from ..ops.nd import fftn_split

__all__ = ["NLSEPlan", "nlse_init", "nlse_step", "nlse_rollout",
           "bright_soliton", "free_gaussian"]


class NLSEPlan:
    """Immutable stepper config; compiled rollouts cached per
    (steps, keep_every) — build once, replay many (plan-object jit cache,
    like models/ks.py)."""

    def __init__(self, consts):
        self._consts = consts
        self._jit_cache = {}

    def __getitem__(self, key):
        return self._consts[key]


def nlse_init(shape, lengths, dt: float, g: float = 1.0,
              potential=None) -> NLSEPlan:
    """Precompute the half/full linear phase tables for a periodic grid.

    shape: (n,) or (ny, nx) grid points; lengths: matching box sizes;
    g: nonlinear coefficient (+1 focusing, -1 defocusing, 0 linear);
    potential: optional real array V broadcastable to `shape` (GPE trap).
    """
    shape = tuple(int(s) for s in shape)
    if np.ndim(lengths) == 0:
        lengths = (float(lengths),) * len(shape)
    lengths = tuple(float(L) for L in lengths)
    if len(lengths) != len(shape):
        raise ValueError("lengths must match shape rank")
    if len(shape) not in (1, 2):
        raise ValueError("1-D and 2-D grids supported")
    k2 = np.zeros(shape, np.float64)
    for ax, (n, L) in enumerate(zip(shape, lengths)):
        k = 2.0 * np.pi * np.fft.fftfreq(n, L / n).astype(np.float64)
        kshape = [1] * len(shape)
        kshape[ax] = n
        k2 = k2 + (k.reshape(kshape)) ** 2
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    # linear propagator over a full step: exp(-i k^2 dt / 2)
    ph = -0.5 * k2 * float(dt)
    consts = {
        "shape": shape, "dt": float(dt), "g": float(g),
        "cos": f32(np.cos(ph)), "sin": f32(np.sin(ph)),
        "ndim": len(shape),
    }
    if potential is not None:
        consts["V"] = f32(potential)
    return NLSEPlan(consts)


def _linear(c, ur, ui):
    """Full linear step: multiply the spectrum by exp(-i k^2 dt / 2)."""
    axes = tuple(range(ur.ndim - c["ndim"], ur.ndim))
    fr, fi = fftn_split(ur, ui, axes, FORWARD, None)
    cs, sn = c["cos"], c["sin"]
    gr, gi = fr * cs - fi * sn, fr * sn + fi * cs
    n_total = float(np.prod(c["shape"]))
    return fftn_split(gr, gi, axes, INVERSE, 1.0 / n_total)


def _phase(c, ur, ui, frac):
    """Nonlinear/potential rotation over frac*dt: exact phase
    exp(i (g |psi|^2 - V) frac dt)."""
    theta = c["g"] * (ur * ur + ui * ui)
    V = c._consts.get("V")
    if V is not None:
        theta = theta - V
    theta = theta * (frac * c["dt"])
    cs, sn = jnp.cos(theta), jnp.sin(theta)
    return ur * cs - ui * sn, ur * sn + ui * cs


def nlse_step(c, ur, ui):
    """One Strang split step: half nonlinear, full linear, half nonlinear."""
    ur, ui = _phase(c, ur, ui, 0.5)
    ur, ui = _linear(c, ur, ui)
    return _phase(c, ur, ui, 0.5)


def nlse_rollout(c, psi0, steps: int, keep_every: int = 0):
    """Integrate the split (re, im) field psi0 for `steps` Strang steps in
    one jitted lax.scan.  psi0: (re, im) pair or complex array [..., *shape].
    keep_every=0 returns the final split field; keep_every=s additionally
    returns the trajectory sampled every s steps (split pair with a new
    leading time axis).

    Consecutive half-phases are NOT merged across step boundaries so the
    per-sample states are true Strang states (merging would change only
    constants, not cost: the phase is VPU-cheap next to the transforms).
    """
    from ..core.complex_utils import promote_to_split

    ur, ui = promote_to_split(psi0)
    if keep_every and steps % keep_every:
        raise ValueError("steps must be a multiple of keep_every")
    cache = c._jit_cache
    run = cache.get((steps, keep_every))
    if run is None:

        @jax.jit
        def run(ur, ui):
            if keep_every:
                def inner(carry, _):
                    return nlse_step(c, *carry), None

                def chunk(carry, _):
                    carry, _ = jax.lax.scan(
                        inner, carry, None, length=keep_every)
                    return carry, carry

                carry, traj = jax.lax.scan(
                    chunk, (ur, ui), None, length=steps // keep_every)
                return carry, traj

            def body(carry, _):
                return nlse_step(c, *carry), None

            carry, _ = jax.lax.scan(body, (ur, ui), None, length=steps)
            return carry

        cache[(steps, keep_every)] = run
    return run(ur, ui)


def bright_soliton(n: int, length: float, eta: float = 1.0, v: float = 0.0,
                   x0: float = 0.0, t: float = 0.0):
    """Analytic bright soliton of the focusing NLSE (g = +1):
    psi = eta sech(eta (x - x0 - v t)) exp(i (v x + (eta^2 - v^2) t / 2)).
    Returns a split (re, im) float32 pair on an n-point grid centred on 0.
    """
    x = (np.arange(n, dtype=np.float64) - n / 2) * (length / n)
    env = eta / np.cosh(eta * (x - x0 - v * t))
    ph = v * x + 0.5 * (eta * eta - v * v) * t
    return (jnp.asarray((env * np.cos(ph)).astype(np.float32)),
            jnp.asarray((env * np.sin(ph)).astype(np.float32)))


def free_gaussian(grids, sigma: float, t: float = 0.0):
    """Analytic free-Schrodinger (g = 0) evolution of a Gaussian
    psi(x,0) = exp(-|x|^2 / (2 sigma^2)) (any dimension; `grids` is a
    list of 1-D coordinate arrays, meshgrid'ed with ij indexing).
    Returns a split (re, im) float32 pair.
    """
    mesh = np.meshgrid(*[np.asarray(g, np.float64) for g in grids],
                       indexing="ij")
    r2 = sum(m * m for m in mesh)
    s2 = sigma * sigma
    a = s2 + 1j * t  # width parameter evolution
    psi = (s2 / a) ** (len(grids) / 2.0) * np.exp(-r2 / (2.0 * a))
    return (jnp.asarray(np.real(psi).astype(np.float32)),
            jnp.asarray(np.imag(psi).astype(np.float32)))
