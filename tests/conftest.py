"""Test configuration.

Correctness tests run on CPU with 8 virtual devices so the multi-card
sharding paths are exercised without GPUs (the fake-backend mechanism the
reference lacks — SURVEY §4).  Must run before jax is imported anywhere in
the test process.

Tests marked `gpu` need an NVIDIA GPU: they take the `gpu` fixture, which
skips them unless JAX's default backend is a GPU.  On a machine with a
card, run them with the platform left to JAX:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# single-threaded CPU runtime: XLA's CPU FFT splits rows over threads by
# how many are free, which changes the last bit of a result from one call
# to the next; tests that compare two computations of the same value
# need it reproducible
if "xla_cpu_multi_thread_eigen" not in flags:
    flags += " --xla_cpu_multi_thread_eigen=false"
os.environ["XLA_FLAGS"] = flags.strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided per test, never at
    import or collection, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda -m gpu")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def rel_l2(got, want) -> float:
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    denom = np.linalg.norm(want.ravel())
    if denom == 0:
        return float(np.linalg.norm(got.ravel()))
    return float(np.linalg.norm((got - want).ravel()) / denom)


@pytest.fixture
def assert_close():
    def check(got, want, tol=1e-5, what=""):
        err = rel_l2(got, want)
        assert err < tol, f"relative L2 error {err:.3e} >= {tol:.1e} {what}"

    return check
