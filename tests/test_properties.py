"""FFT property tests: shift theorem, convolution theorem, conjugate
symmetry — the stronger regime SURVEY §4 calls for (the reference has
constant-input smoke tests only)."""

import numpy as np
import pytest

import fft_wgpu_tpu as ftt


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def test_time_shift_theorem(rng, assert_close):
    n = 512
    x = crand(rng, n)
    s = 37
    shifted = np.roll(x, s)
    X = np.asarray(ftt.fft(x))
    Xs = np.asarray(ftt.fft(shifted))
    k = np.arange(n)
    assert_close(Xs, X * np.exp(-2j * np.pi * k * s / n), tol=2e-5)


def test_convolution_theorem(rng, assert_close):
    n = 256
    a, b = crand(rng, n), crand(rng, n)
    circ = np.fft.ifft(np.fft.fft(a) * np.fft.fft(b))
    got = np.asarray(ftt.ifft(np.asarray(ftt.fft(a)) * np.asarray(ftt.fft(b))))
    assert_close(got, circ, tol=2e-5)


def test_conjugate_symmetry_real_input(rng):
    n = 256
    x = rng.standard_normal(n).astype(np.float32)
    X = np.asarray(ftt.fft(x))
    np.testing.assert_allclose(X[1:], np.conj(X[1:][::-1]), atol=1e-3)


def test_random_shapes_sweep(rng, assert_close):
    for _ in range(10):
        nd = rng.integers(1, 4)
        shape = tuple(int(rng.integers(1, 5)) * 2 for _ in range(nd - 1)) + (
            int(2 ** rng.integers(3, 11)),
        )
        x = crand(rng, *shape)
        assert_close(ftt.fft(x), np.fft.fft(x, axis=-1), what=f"{shape}")


def test_linearity_under_jit(rng, assert_close):
    import jax

    n = 128
    x, y = crand(rng, n), crand(rng, n)
    f = jax.jit(lambda a, b: ftt.fft(a) + 2.0 * ftt.fft(b))
    assert_close(f(x, y), np.fft.fft(x) + 2.0 * np.fft.fft(y))


@pytest.mark.parametrize("executor,n", [
    ("lax", 1 << 15), ("fourstep", 1 << 15), ("xla", 1 << 12),
    ("lax", 4093), ("lax", 6000),
])
def test_executor_properties(executor, n, rng, assert_close):
    """Linearity, Parseval and the shift theorem for one row through each
    executor, at large, prime and composite n."""
    import jax.numpy as jnp

    from fft_wgpu_tpu.plan.plan import Plan

    p = Plan(n, executor=executor)
    x = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
         ).astype(np.complex64)
    y = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
         ).astype(np.complex64)

    def F(z):
        rr, ri = p._execute_split(jnp.asarray(z.real), jnp.asarray(z.imag),
                                  -1, None)
        return np.asarray(rr) + 1j * np.asarray(ri)

    # linearity
    assert_close(F(2 * x + 3 * y), 2 * F(x) + 3 * F(y), what="linear")
    # Parseval
    X = F(x)
    assert abs(np.sum(np.abs(X) ** 2) / n - np.sum(np.abs(x) ** 2)) \
        / np.sum(np.abs(x) ** 2) < 1e-5
    # shift theorem: x[m - s] <-> X[k] * exp(-2pi i k s / n)
    s = 1234 % n
    xs = np.roll(x, s, axis=-1)
    k = np.arange(n)
    assert_close(F(xs), X * np.exp(-2j * np.pi * k * s / n),
                 what="shift thm")
