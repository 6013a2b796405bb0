"""Spectral filtering (ops/fastconv.py) and the CWT filter bank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fft_wgpu_tpu as ftt


def crand(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [512, 4096, 1000, 521])
def test_spectral_filter_matches_numpy(rng, n):
    """ifft(fft(x) * H) through the plan's "auto" route, for power-of-two,
    composite and prime n."""
    x = crand(rng, 16, n)
    h = crand(rng, n)
    got = ftt.device_get_complex(ftt.SpectralFilter(h)(x))
    want = np.fft.ifft(np.fft.fft(x, axis=-1) * h, axis=-1)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-5, rel


def test_spectral_filter_grad_adjoint(rng):
    """grad through the filter's program matches the composed jnp.fft
    reference (the conj(H) adjoint)."""
    n = 512
    x = crand(rng, 4, n)
    h = crand(rng, n)
    f = ftt.SpectralFilter(h)
    impl = f._build()
    hr = jnp.asarray(h.real.astype(np.float32))
    hi = jnp.asarray(h.imag.astype(np.float32))
    re = jnp.asarray(x.real)
    im = jnp.asarray(x.imag)

    def loss(a, b):
        yr, yi = impl(a, b, hr, hi)
        return jnp.sum(yr ** 2 + 2.0 * yi ** 2)

    def loss_ref(a, b):
        z = jnp.fft.ifft(jnp.fft.fft(jax.lax.complex(a, b), axis=-1)
                         * jax.lax.complex(hr, hi), axis=-1)
        return jnp.sum(jnp.real(z) ** 2 + 2.0 * jnp.imag(z) ** 2)

    ga = jax.grad(loss, argnums=(0, 1))(re, im)
    gb = jax.grad(loss_ref, argnums=(0, 1))(re, im)
    for u, v in zip(ga, gb):
        rel = float(jnp.linalg.norm(u - v) / jnp.linalg.norm(v))
        assert rel < 1e-5, rel


def test_spectral_filter_plan(rng):
    n = 1024
    x = crand(rng, 8, n)
    H = crand(rng, n)
    f = ftt.SpectralFilter(H)
    got = np.asarray(ftt.device_get_complex(f.apply(x)))
    want = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    # time-domain construction = circular convolution with h
    h = crand(rng, n)
    g = ftt.SpectralFilter(h, domain="time")
    got = np.asarray(ftt.device_get_complex(g(x)))
    want = np.fft.ifft(np.fft.fft(x, axis=-1) * np.fft.fft(h), axis=-1)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_spectral_filter_validation(rng):
    with pytest.raises(ValueError):
        ftt.SpectralFilter(np.ones((2, 8)))
    with pytest.raises(ValueError):
        ftt.SpectralFilter(np.ones(8), n=16)
    with pytest.raises(ValueError):
        ftt.SpectralFilter(np.ones(8), domain="bogus")
    f = ftt.SpectralFilter(np.ones(8, np.complex64))
    with pytest.raises(ValueError):
        f.apply(np.zeros((2, 16), np.complex64))


def test_spectral_filter_identity_and_delay(rng):
    n = 256
    x = crand(rng, 3, n)
    ident = ftt.SpectralFilter(np.ones(n, np.complex64))
    got = np.asarray(ftt.device_get_complex(ident(x)))
    assert np.linalg.norm(got - x) / np.linalg.norm(x) < 1e-5
    # unit-delay impulse response shifts circularly by one
    h = np.zeros(n, np.complex64)
    h[1] = 1.0
    d = ftt.SpectralFilter(h, domain="time")
    got = np.asarray(ftt.device_get_complex(d(x)))
    assert np.linalg.norm(got - np.roll(x, 1, -1)) / np.linalg.norm(x) < 1e-5


def test_cwt_bank_matches_direct_convolution(rng):
    """The CWT plan's bank pass equals one 'same' convolution per scale
    (scipy.signal.cwt semantics), computed directly in float64."""
    n = 300
    x = rng.standard_normal(n).astype(np.float32)
    widths = np.array([1.0, 2.5, 4.0, 7.0])
    got = np.asarray(ftt.CWT(n, widths)(x))
    for i, w in enumerate(widths):
        L = min(int(10 * w), n)
        wav = np.asarray(ftt.ricker(L, w), np.float64)
        want = np.convolve(x.astype(np.float64), wav[::-1], mode="same")
        rel = np.linalg.norm(got[i] - want) / np.linalg.norm(want)
        assert rel < 1e-5, (w, rel)


def test_cwt_plan_grad_matches_composed(rng):
    """grad wrt the signal through the CWT plan equals grad through a
    composed jnp.fft form of the same bank filter."""
    n = 256
    widths = np.arange(1, 6)
    p = ftt.CWT(n, widths)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    g = jax.grad(lambda v: jnp.sum(p(v) ** 2))(x)
    eps = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    # the map is linear and the loss quadratic: the central difference
    # is exact for any step
    f = lambda v: jnp.sum(p(v) ** 2)
    num = (f(x + eps) - f(x - eps)) / 2.0
    ana = jnp.sum(g * eps)
    assert abs(float(num - ana)) / abs(float(ana)) < 1e-4


def test_cwt_plan_matches_oneshot(rng):
    """The CWT plan must agree with the one-shot cwt and stay
    differentiable."""
    n = 400
    x = rng.standard_normal(n).astype(np.float32)
    widths = np.arange(1, 11)
    want = np.asarray(ftt.cwt(x, widths))
    p = ftt.CWT(n, widths)
    got = np.asarray(p(x))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel
    # complex wavelet path
    wantc = np.asarray(ftt.device_get_complex(ftt.cwt(x, widths,
                                                      "morlet2", w=6.0)))
    pc = ftt.CWT(n, widths, "morlet2", w=6.0)
    gotc = np.asarray(ftt.device_get_complex(pc(x)))
    assert np.linalg.norm(gotc - wantc) / np.linalg.norm(wantc) < 1e-4
    with pytest.raises(ValueError):
        p.apply(np.zeros(n + 1, np.float32))
    # differentiable wrt the signal
    g = jax.grad(lambda s: jnp.sum(p._jit(s, p._Br, p._Bi)[0] ** 2))(
        jnp.asarray(x))
    assert np.isfinite(np.asarray(g)).all()
