"""Forward FFT example + micro-bench.

Parity with the reference's examples/basic.rs (E1, SURVEY §2): 2500 rows x
512 points, repeated transform loop with timing — the replay loop is
chained on device inside one jit (the reference times
H2D + readback every iteration, examples/basic.rs:70-129; here the host
boundary is crossed once on each side).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

import jax
import jax.numpy as jnp
import numpy as np

import fft_wgpu_tpu as ftt


def main():
    batch, n, iters = 2500, 512, 1000
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(
        np.complex64
    )

    p = ftt.plan(n)

    # one-shot correctness vs numpy
    X = ftt.device_get_complex(p.forward(x))
    ref = np.fft.fft(x, axis=-1)
    err = np.linalg.norm(X - ref) / np.linalg.norm(ref)
    print(f"forward {batch}x{n}: rel-L2 vs numpy = {err:.2e}")
    # the reference's forward example never asserts (examples/basic.rs:250,
    # the quirk SURVEY §7 calls out); ours does, like its siblings
    assert err < 1e-5, f"forward parity failed: rel-L2 {err:.2e} >= 1e-5"

    # timed replay, chained on device (one program, `iters` executions)
    re = jnp.asarray(x.real)
    im = jnp.asarray(x.imag)

    @jax.jit
    def replay(a, b):
        def body(_, c):
            return p._execute_split(c[0], c[1], -1, None)

        a, b = jax.lax.fori_loop(0, iters, body, (a, b))
        return jnp.sum(a[..., 0])

    _ = float(replay(re, im))  # compile
    t0 = time.perf_counter()
    _ = float(replay(re, im))
    dt = time.perf_counter() - t0
    gf = 5 * n * np.log2(n) * batch * iters / dt / 1e9
    print(f"{iters} iters in {dt:.3f}s -> {dt/iters*1e6:.1f} us/iter, {gf:.0f} GFLOP/s")


if __name__ == "__main__":
    main()
