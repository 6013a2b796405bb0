"""Bluestein chirp-z path for lengths with large prime factors."""

import numpy as np
import pytest

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.ops.bluestein import fft_bluestein_split


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("n", [521, 1031, 4099, 2 * 3 * 1009])
def test_bluestein_matches_numpy(n, rng, assert_close):
    # primes (and a 1009-factor composite) beyond MAX_DIRECT
    x = crand(rng, 2, n)
    assert_close(ftt.fft(x), np.fft.fft(x, axis=-1), what=f"(n={n})")


def test_bluestein_inverse_and_roundtrip(rng, assert_close):
    n = 1031
    x = crand(rng, n)
    assert_close(ftt.ifft(x), np.fft.ifft(x))
    assert_close(ftt.ifft(ftt.fft(x)), x)


def test_bluestein_direct_call(rng, assert_close):
    import jax.numpy as jnp

    n = 4099
    x = crand(rng, 3, n)
    rr, ii = fft_bluestein_split(
        jnp.asarray(x.real), jnp.asarray(x.imag), -1
    )
    assert_close(np.asarray(rr) + 1j * np.asarray(ii), np.fft.fft(x, axis=-1))


def test_small_prime_stays_direct(rng, assert_close):
    # below BLUESTEIN_MIN the direct DFT matmul is used — still correct
    x = crand(rng, 251)
    assert_close(ftt.fft(x), np.fft.fft(x))
