"""Pseudo-spectral incompressible 3-D Navier-Stokes on the distributed
pencil FFT stack — the framework's flagship multi-chip model.

    du/dt + (u . grad) u = -grad p + nu lap(u),   div u = 0

solved in rotational form on a [n, n, n] periodic box [0, 2pi)^3:
the nonlinear term is the Lamb vector u x omega evaluated
pseudo-spectrally (2/3-rule dealiased), pressure is eliminated by the
Leray projection P(F) = F - k (k . F)/k^2, viscosity integrates exactly
via the spectral integrating factor, and advection uses Heun RK2 — the
same splitting as models/navier_stokes.py lifted to 3-D.

Every transform is a pencil-decomposed distributed 3-D R2C/C2R over a
2-D `jax.sharding.Mesh` (`parallel/pencil.py`: shard_map + chunked
all-to-all corner turns that overlap with per-pencil compute), so a
rollout scales to real multi-chip meshes; the whole rollout is ONE
jitted `lax.scan` program.  9 distributed 3-D transforms per nonlinear
evaluation (6 inverse + 3 forward), 18 per RK2 step — the classic
spectral-DNS cost profile.  The reference ships no models and no
distribution (SURVEY §1); this is the "many transforms in one
submission" pattern (fft_wgpu src/examples/basic_inverse2.rs:85-92)
taken to its multi-chip conclusion.

Velocity spectra stay complex64 INSIDE the single jitted program only;
the public boundary is real [3, n, n, n] fields (framework invariant:
complex never crosses host<->device).

Oracle (tests/test_ns3d.py): the ABC flow is a Beltrami field
(curl u = u), so its Lamb vector vanishes identically and the exact
solution is pure viscous decay u(t) = u0 exp(-nu t) — reproduced by the
integrating factor to FFT roundoff.  The distributed rollout is also
checked step-for-step against an independent single-device jnp.fft
implementation of the same discrete scheme.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NS3DPlan", "ns3d_init", "ns3d_step", "ns3d_rollout",
           "abc_flow", "project_divergence_free"]


class NS3DPlan:
    """Immutable stepper config (plan-object semantics: build once with
    ns3d_init, replay many; compiled rollouts cached per step count)."""

    def __init__(self, consts):
        self._consts = consts
        self._jit_cache = {}

    def __getitem__(self, key):
        return self._consts[key]


def _wavenumbers(n: int):
    """Integer wavenumbers for an rfft3d layout [n, n, n//2+1] on
    [0, 2pi)^3, plus k^2, a zero-safe k^2, and the 2/3-rule mask."""
    kx = np.fft.fftfreq(n, 1.0 / n).astype(np.float32)[:, None, None]
    ky = np.fft.fftfreq(n, 1.0 / n).astype(np.float32)[None, :, None]
    kz = np.fft.rfftfreq(n, 1.0 / n).astype(np.float32)[None, None, :]
    ksq = kx * kx + ky * ky + kz * kz
    cut = n / 3.0
    mask = ((np.abs(kx) <= cut) & (np.abs(ky) <= cut)
            & (kz <= cut)).astype(np.float32)
    return kx, ky, kz, ksq, mask


def ns3d_init(n: int, nu: float, dt: float, mesh=None,
              overlap_chunks: int | None = None,
              comm_dtype=None, transposed_spectra: bool = True) -> NS3DPlan:
    """Precompute spectral constants for an n^3 grid; `mesh` is the 2-D
    pencil mesh (default: all devices, `make_pencil_mesh()`).

    `comm_dtype=bfloat16` runs every distributed transform's corner
    turn in bf16 (half the wire bytes of the 18 transforms/step — see
    parallel/pencil.fft3d) for ~1e-3 rel spectrum rounding per step.
    Default exact f32.

    `transposed_spectra` (default True) keeps every spectrum in the
    transposed pencil distribution (rfft3d transposed_output paired with
    irfft3d transposed_input): each R2C/C2R pair pays 4 corner turns
    instead of 8 with identical logical values — spectral elementwise
    math is distribution-agnostic.  Set False to force natural-layout
    spectra (debug/interop)."""
    from ..parallel.mesh import make_pencil_mesh

    kx, ky, kz, ksq, mask = _wavenumbers(n)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return NS3DPlan({
        "n": n, "nu": float(nu), "dt": float(dt),
        "mesh": mesh or make_pencil_mesh(),
        "chunks": overlap_chunks,
        "comm_dtype": comm_dtype,
        "transposed": bool(transposed_spectra),
        "kx": f32(kx), "ky": f32(ky), "kz": f32(kz),
        "ksq_safe": f32(np.where(ksq == 0.0, 1.0, ksq)),
        "mask": f32(mask),
        "visc": f32(np.exp(-nu * ksq * dt)),
    })


def _rfft3(c, x):
    from ..parallel.pencil import rfft3d

    return rfft3d(x, c["mesh"], overlap_chunks=c["chunks"],
                  comm_dtype=c["comm_dtype"],
                  transposed_output=c["transposed"])


def _irfft3(c, X):
    from ..parallel.pencil import irfft3d

    return irfft3d(X, c["n"], c["mesh"], overlap_chunks=c["chunks"],
                   comm_dtype=c["comm_dtype"],
                   transposed_input=c["transposed"])


def project_divergence_free(c, Fx, Fy, Fz):
    """Leray projection in spectral space: F - k (k . F) / k^2 (the k=0
    mode passes through untouched — ksq_safe avoids the 0/0)."""
    kx, ky, kz = c["kx"], c["ky"], c["kz"]
    div = (kx * Fx + ky * Fy + kz * Fz) / c["ksq_safe"]
    return Fx - kx * div, Fy - ky * div, Fz - kz * div


def _nonlinear(c, Ux, Uy, Uz):
    """P(u x omega)_hat, dealiased, from the complex velocity spectrum."""
    kx, ky, kz = c["kx"], c["ky"], c["kz"]
    ii = jnp.complex64(1j)
    # vorticity: omega_hat = i k x u_hat
    Wx = ii * (ky * Uz - kz * Uy)
    Wy = ii * (kz * Ux - kx * Uz)
    Wz = ii * (kx * Uy - ky * Ux)
    ux, uy, uz = _irfft3(c, Ux), _irfft3(c, Uy), _irfft3(c, Uz)
    wx, wy, wz = _irfft3(c, Wx), _irfft3(c, Wy), _irfft3(c, Wz)
    # Lamb vector u x omega in real space
    Fx = _rfft3(c, uy * wz - uz * wy)
    Fy = _rfft3(c, uz * wx - ux * wz)
    Fz = _rfft3(c, ux * wy - uy * wx)
    m = c["mask"]
    Fx, Fy, Fz = project_divergence_free(c, Fx * m, Fy * m, Fz * m)
    return Fx, Fy, Fz


def ns3d_step(c, Ux, Uy, Uz):
    """One Heun (RK2) step with exact viscous integrating factor on the
    complex velocity spectrum (inside-jit state only)."""
    dt, E = c["dt"], c["visc"]
    N1 = _nonlinear(c, Ux, Uy, Uz)
    P = [(u + dt * n) * E for u, n in zip((Ux, Uy, Uz), N1)]
    N2 = _nonlinear(c, *P)
    return tuple(
        u * E + 0.5 * dt * (n1 * E + n2)
        for u, n1, n2 in zip((Ux, Uy, Uz), N1, N2)
    )


def ns3d_rollout(c, u0, steps: int):
    """Integrate real velocity u0 [3, n, n, n] for `steps` RK2 steps in
    one jitted lax.scan; returns the final real velocity [3, n, n, n].
    The initial spectrum is dealiased and Leray-projected, so u0 need not
    be exactly divergence-free."""
    cache = c._jit_cache
    run = cache.get(steps)
    if run is None:

        @jax.jit
        def run(u0):
            m = c["mask"]
            U = [_rfft3(c, u0[i]) * m for i in range(3)]
            U = project_divergence_free(c, *U)

            def body(carry, _):
                return ns3d_step(c, *carry), None

            U, _ = jax.lax.scan(body, tuple(U), None, length=steps)
            return jnp.stack([_irfft3(c, Ui) for Ui in U])

        cache[steps] = run
    return run(u0)


def abc_flow(n: int, A: float = 1.0, B: float = 1.0, C: float = 1.0):
    """Arnold-Beltrami-Childress velocity on [0, 2pi)^3 — a curl
    eigenflow (curl u = u), so u x omega = 0 and the exact NS solution is
    u(t) = u0 exp(-nu t).  Returns real [3, n, n, n]."""
    s = np.arange(n, dtype=np.float64) * (2.0 * np.pi / n)
    x = s[:, None, None]
    y = s[None, :, None]
    z = s[None, None, :]
    zero = np.zeros((n, n, n))
    ux = A * np.sin(z) + C * np.cos(y) + zero
    uy = B * np.sin(x) + A * np.cos(z) + zero
    uz = C * np.sin(y) + B * np.cos(x) + zero
    return jnp.asarray(np.stack([ux, uy, uz]).astype(np.float32))
