"""Distributed 3-D Navier-Stokes DNS demo on the pencil mesh.

Validates the exact ABC-Beltrami viscous decay, then runs a decaying
isotropic-turbulence rollout — 18 distributed pencil transforms per RK2
step, one jitted lax.scan program over every device on the mesh.

Run on the 8-device virtual CPU mesh:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/ns3d_dns.py
(on several GPUs the same code shards over the physical mesh).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

import numpy as np

from fft_wgpu_tpu.models import ns3d


def main():
    import jax

    print(f"mesh devices: {len(jax.devices())}")
    n = 32

    # 1. exactness: a Beltrami flow decays analytically, u(t)=u0 e^{-nu t}
    nu, dt, steps = 0.05, 0.05, 40
    c = ns3d.ns3d_init(n, nu, dt)
    u0 = ns3d.abc_flow(n)
    t0 = time.perf_counter()
    uT = np.asarray(ns3d.ns3d_rollout(c, u0, steps))
    t1 = time.perf_counter()
    expect = np.asarray(u0) * np.exp(-nu * dt * steps, dtype=np.float32)
    err = np.linalg.norm(uT - expect) / np.linalg.norm(expect)
    print(f"ABC decay over t={nu*dt*steps:.2f}: rel err {err:.2e} "
          f"({steps} steps in {t1-t0:.1f}s incl. compile)")
    assert err < 1e-4

    # 2. decaying turbulence: random solenoidal field, watch energy fall
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal((3, n, n, n)).astype(np.float32)
    c2 = ns3d.ns3d_init(n, nu=2e-3, dt=2e-3)
    e_prev = None
    u = u0
    for chunk in range(3):
        u = np.asarray(ns3d.ns3d_rollout(c2, u, 25))
        e = float((u ** 2).mean())
        print(f"t={(chunk+1)*25*2e-3:.3f}: kinetic energy {e:.4f}")
        assert e_prev is None or e < e_prev, "unforced energy must decay"
        e_prev = e
    print("OK")


if __name__ == "__main__":
    main()
