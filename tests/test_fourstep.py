"""Four-step large-N decomposition (BASELINE.json config 3)."""

import numpy as np
import pytest

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.ops import fourstep


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def test_choose_factors():
    # powers of two split as evenly as the exponent allows (n1 <= n2)
    assert fourstep.choose_factors(1 << 22) == (2048, 2048)
    assert fourstep.choose_factors(1 << 24) == (4096, 4096)
    assert fourstep.choose_factors(1 << 21) == (1024, 2048)
    assert fourstep.choose_factors(32768) == (128, 256)
    assert fourstep.choose_factors(120) == (10, 12)


@pytest.mark.parametrize("n", [4096, 32768])
def test_fourstep_matches_numpy(n, rng, assert_close):
    x = crand(rng, 2, n)
    got = ftt.fft(x, executor="fourstep")
    assert_close(got, np.fft.fft(x, axis=-1), what=f"(n={n})")


@pytest.mark.parametrize("n", [4096])
def test_fourstep_inverse_normalized(n, rng, assert_close):
    x = crand(rng, n)
    assert_close(ftt.ifft(x, executor="fourstep"), np.fft.ifft(x))


def test_fourstep_large_n_2_20(rng, assert_close):
    # N = 2^20 single row (the BASELINE latency config, CPU-sized here).
    n = 1 << 20
    x = crand(rng, n)
    got = ftt.fft(x, executor="fourstep")
    assert_close(got, np.fft.fft(x), what="(n=2^20)")


def test_fourstep_roundtrip(rng, assert_close):
    n = 65536
    x = crand(rng, n)
    y = ftt.ifft(ftt.fft(x, executor="fourstep"), executor="fourstep")
    assert_close(y, x)
