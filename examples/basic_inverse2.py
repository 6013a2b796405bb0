"""Two-pass inverse: unnormalized IFFT then standalone normalize.

Parity with the reference's examples/basic_inverse2.rs (E3, SURVEY §2):
`Onlyinverse.proc` chained with `Normalize.proc` inside one submission —
here, function composition under one `jax.jit` (the reference records both
procs into one CommandEncoder, basic_inverse2.rs:85-92).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

import fft_wgpu_tpu as ftt


def main():
    batch, n = 2500, 512
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(
        np.complex64
    )

    only = ftt.Onlyinverse(n)
    nrm = ftt.Normalize(n)
    two_pass = jax.jit(lambda v: nrm.proc(only.proc(v)))

    # complex data enters the device as planar f32, then composes freely
    # under jit
    xd = ftt.device_put_complex(x)
    y = ftt.device_get_complex(two_pass(xd))
    ref = np.fft.ifft(x, axis=-1)
    err = np.linalg.norm(y - ref) / np.linalg.norm(ref)
    print(f"two-pass inverse {batch}x{n}: rel-L2 vs numpy = {err:.2e}")
    assert err < 1e-5


if __name__ == "__main__":
    main()
