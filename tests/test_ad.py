"""Autodiff through the plan layer's executors and the real transforms.

No executor carries a custom VJP: the "lax" route differentiates through
`lax.fft`'s own transpose rule, the others through plain jnp.  Every
transform is linear, so its gradient is checked against the linear
adjoint (the sign-flipped, unscaled transform of the cotangent) and
against jax.grad through jnp.fft of the same loss.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fft_wgpu_tpu.plan.plan import Plan


def _relg(a, b):
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


@pytest.fixture
def data(rng):
    n = 1024
    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    return n, mk


@pytest.mark.parametrize("executor,n", [
    (ex, n) for ex in ("lax", "xla", "fourstep") for n in (256, 1000, 521)
] + [("direct", 256), ("direct", 521)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_grad_executor_is_linear_adjoint(executor, n, sign, rng):
    """d/dx <W, F x> = F^H W: the sign-flipped transform of the
    cotangent, with the same scale."""
    p = Plan(n, executor=executor)
    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    re, im, wr, wi = mk(3, n), mk(3, n), mk(3, n), mk(3, n)
    scale = None if sign == -1 else 1.0 / n

    def loss(a, b):
        Xr, Xi = p._execute_split(a, b, sign, scale)
        return jnp.sum(Xr * wr + Xi * wi)

    gr, gi = jax.jit(jax.grad(loss, argnums=(0, 1)))(re, im)
    W = np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64)
    # F = s * DFT_sign; F^H W = s * DFT_{-sign} W (unnormalized)
    adj = (np.fft.fft(W, axis=-1) if sign == +1
           else np.fft.ifft(W, axis=-1) * n) * (scale or 1.0)
    got = np.asarray(gr) + 1j * np.asarray(gi)
    err = np.linalg.norm(got - adj) / np.linalg.norm(adj)
    assert err < 1e-5, f"{executor} n={n} sign={sign}: {err:.3e}"


def test_grad_fft_batched(data):
    from fft_wgpu_tpu.plan.plan import get_plan

    n, mk = data
    p = get_plan(n)
    re, im, wr, wi = mk(4, n), mk(4, n), mk(4, n), mk(4, n)

    def loss(fft):
        def f(a, b):
            Xr, Xi = fft(a, b)
            return jnp.sum(Xr * wr + Xi * wi)
        return jax.grad(f, argnums=(0, 1))(re, im)

    g1 = loss(lambda a, b: p._execute_split(a, b, -1, None))
    g2 = loss(lambda a, b: (
        jnp.real(jnp.fft.fft(jax.lax.complex(a, b), axis=-1)),
        jnp.imag(jnp.fft.fft(jax.lax.complex(a, b), axis=-1))))
    assert _relg(g1[0], g2[0]) < 1e-5 and _relg(g1[1], g2[1]) < 1e-5
    # inverse with folded scale
    g3 = loss(lambda a, b: p._execute_split(a, b, +1, 1.0 / n))
    g4 = loss(lambda a, b: (
        jnp.real(jnp.fft.ifft(jax.lax.complex(a, b), axis=-1)),
        jnp.imag(jnp.fft.ifft(jax.lax.complex(a, b), axis=-1))))
    assert _relg(g3[0], g4[0]) < 1e-5 and _relg(g3[1], g4[1]) < 1e-5


def test_grad_non_minor_axis(data):
    from fft_wgpu_tpu.plan.plan import get_plan

    n, mk = data
    re, im = mk(2, 256, 256), mk(2, 256, 256)
    wr, wi = mk(2, 256, 256), mk(2, 256, 256)
    p = get_plan(256)

    def f(a, b):
        Xr, Xi = p._execute_split_axis(a, b, -1, None, -2)
        return jnp.sum(Xr * wr + Xi * wi)

    def fr(a, b):
        X = jnp.fft.fft(jax.lax.complex(a, b), axis=-2)
        return jnp.sum(jnp.real(X) * wr + jnp.imag(X) * wi)

    g1 = jax.grad(f, argnums=(0, 1))(re, im)
    g2 = jax.grad(fr, argnums=(0, 1))(re, im)
    assert _relg(g1[0], g2[0]) < 1e-5 and _relg(g1[1], g2[1]) < 1e-5


@pytest.mark.parametrize("n", [1024, 1001])
def test_grad_rfft_irfft(n, rng):
    from fft_wgpu_tpu.ops.rfft import irfft_last_split, rfft_last_split

    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    x = mk(4, n)
    wr, wi = mk(4, n // 2 + 1), mk(4, n // 2 + 1)

    def f(a):
        Xr, Xi = rfft_last_split(a, None)
        return jnp.sum(Xr * wr + Xi * wi)

    def fr(a):
        X = jnp.fft.rfft(a, axis=-1)
        return jnp.sum(jnp.real(X) * wr + jnp.imag(X) * wi)

    assert _relg(jax.grad(f)(x), jax.grad(fr)(x)) < 1e-5

    Xr, Xi, wv = mk(4, n // 2 + 1), mk(4, n // 2 + 1), mk(4, n)

    def g(a, b):
        return jnp.sum(irfft_last_split(a, b, n, 1.0 / n) * wv)

    def gr(a, b):
        # the same map: DC (and Nyquist) imaginary parts discarded
        b = b.at[..., 0].set(0.0)
        if n % 2 == 0:
            b = b.at[..., n // 2].set(0.0)
        return jnp.sum(jnp.fft.irfft(jax.lax.complex(a, b), n=n,
                                     axis=-1) * wv)

    g1 = jax.grad(g, argnums=(0, 1))(Xr, Xi)
    g2 = jax.grad(gr, argnums=(0, 1))(Xr, Xi)
    assert _relg(g1[0], g2[0]) < 1e-5 and _relg(g1[1], g2[1]) < 1e-5


def test_grad_large_single_row(rng):
    from fft_wgpu_tpu.plan.plan import get_plan

    n = 1 << 15
    p = get_plan(n)
    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    re, im, wr, wi = mk(1, n), mk(1, n), mk(1, n), mk(1, n)

    def f(a, b):
        Xr, Xi = p._execute_split(a, b, -1, None)
        return jnp.sum(Xr * wr + Xi * wi)

    def fr(a, b):
        X = jnp.fft.fft(jax.lax.complex(a, b), axis=-1)
        return jnp.sum(jnp.real(X) * wr + jnp.imag(X) * wi)

    g1 = jax.grad(f, argnums=(0, 1))(re, im)
    g2 = jax.grad(fr, argnums=(0, 1))(re, im)
    assert _relg(g1[0], g2[0]) < 1e-5 and _relg(g1[1], g2[1]) < 1e-5


def test_jvp_forward_mode(data):
    """Forward mode: jvp(tangent) == fft(tangent) for a linear map."""
    from fft_wgpu_tpu.ops.rfft import rfft_last_split
    from fft_wgpu_tpu.plan.plan import get_plan

    n, mk = data
    p = get_plan(n)
    re, im, tr, ti = mk(2, n), mk(2, n), mk(2, n), mk(2, n)
    _, (dr, di) = jax.jvp(
        lambda a, b: p._execute_split(a, b, -1, None), (re, im), (tr, ti))
    ref = jnp.fft.fft(jax.lax.complex(tr, ti), axis=-1)
    assert _relg(dr, jnp.real(ref)) < 1e-5
    assert _relg(di, jnp.imag(ref)) < 1e-5

    x, tx = mk(2, n), mk(2, n)
    _, (dR, dI) = jax.jvp(lambda a: rfft_last_split(a, None), (x,), (tx,))
    refr = jnp.fft.rfft(tx, axis=-1)
    assert _relg(dR, jnp.real(refr)) < 1e-5
    assert _relg(dI, jnp.imag(refr)) < 1e-5


class TestNewOpsAD:
    def test_frft_adjoint_consistency(self, rng):
        # frft is linear: <F x, y> == <x, F^H y> with F^H = F^{-a}
        import jax
        import jax.numpy as jnp
        import fft_wgpu_tpu as ftt

        n, a = 96, 0.8
        xr = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        xi = jnp.asarray(rng.standard_normal(n).astype(np.float32))

        def loss(re, im):
            F = ftt.frft(jax.lax.complex(re, im), a)
            return jnp.sum(jnp.real(F) ** 2 + jnp.imag(F) ** 2)

        g = jax.grad(loss, argnums=(0, 1))(xr, xi)
        # numerical directional derivative
        dr = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        di = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        # the loss is quadratic, so the central difference is exact for
        # any step: a large one keeps f32 cancellation out of it
        eps = 1e-1
        f1 = loss(xr + eps * dr, xi + eps * di)
        f0 = loss(xr - eps * dr, xi - eps * di)
        num = (f1 - f0) / (2 * eps)
        ana = jnp.sum(g[0] * dr + g[1] * di)
        assert abs(float(num - ana)) / abs(float(ana)) < 2e-3

    def test_dht_grad(self, rng):
        import jax
        import jax.numpy as jnp
        import fft_wgpu_tpu as ftt

        x = jnp.asarray(rng.standard_normal(64).astype(np.float32))
        g = jax.grad(lambda v: jnp.sum(ftt.dht(v) ** 2))(x)
        # DHT is symmetric: grad = 2 * DHT(DHT(x)) = 2 n x
        np.testing.assert_allclose(np.asarray(g), 2 * 64 * np.asarray(x),
                                   rtol=1e-4)

    def test_short_time_fft_grad_flows(self, rng):
        import jax
        import jax.numpy as jnp
        import scipy.signal as ss
        import fft_wgpu_tpu as ftt

        st = ftt.ShortTimeFFT(ss.windows.hann(16, sym=False), 4, 1.0)
        x = jnp.asarray(rng.standard_normal(80).astype(np.float32))

        def loss(v):
            S = st.stft(v)
            return jnp.sum(jnp.abs(S) ** 2)

        g = jax.grad(loss)(x)
        assert np.all(np.isfinite(np.asarray(g)))
        d = jnp.asarray(rng.standard_normal(80).astype(np.float32))
        eps = 1e-2
        num = (loss(x + eps * d) - loss(x - eps * d)) / (2 * eps)
        ana = jnp.sum(g * d)
        assert abs(float(num - ana)) / max(abs(float(ana)), 1e-6) < 5e-3
