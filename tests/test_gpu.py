"""GPU tier: the BASELINE.md configs and the plan API's parity,
donation, AOT-replay and gradient checks on an NVIDIA GPU.

Run on a machine with a card:
    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
Elsewhere every test here skips through the `gpu` fixture (conftest.py).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture
def ftt(gpu):
    import fft_wgpu_tpu

    return fft_wgpu_tpu


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_config1_n1024_vs_naive(ftt, rng):
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    got = ftt.device_get_complex(ftt.fft(x))
    assert _rel(got, ftt.naive_dft(x)) < TOL


def test_config2_batched_4096(ftt, rng):
    x = (rng.standard_normal((256, 4096))
         + 1j * rng.standard_normal((256, 4096))).astype(np.complex64)
    assert _rel(ftt.device_get_complex(ftt.fft(x)),
                np.fft.fft(x, axis=-1)) < TOL
    assert _rel(ftt.device_get_complex(ftt.ifft(x)),
                np.fft.ifft(x, axis=-1)) < TOL


def test_config3_large_n_roundtrip_device_side(ftt):
    """2^20 single-shot: device-side roundtrip + impulse, scalar
    transfers only."""
    import jax
    import jax.numpy as jnp

    n = 1 << 20
    re = jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32)
    im = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float32)
    p = ftt.plan(n)

    @jax.jit
    def rt(a, b):
        fr, fi = p._execute_split(a, b, -1, None)
        rr, ri = p._execute_split(fr, fi, +1, 1.0 / n)
        return jnp.sqrt(jnp.sum((rr - a) ** 2 + (ri - b) ** 2)
                        / jnp.sum(a ** 2 + b ** 2))

    assert float(rt(re, im)) < TOL

    d = jnp.zeros((n,), jnp.float32).at[0].set(1.0)
    dr, di = jax.jit(lambda a, b: p._execute_split(a, b, -1, None))(
        d, jnp.zeros_like(d))
    err = float(jnp.max(jnp.abs(dr - 1.0)) + jnp.max(jnp.abs(di)))
    assert err < TOL


def test_config4_2d_and_r2c(ftt, rng):
    x2 = (rng.standard_normal((512, 512))
          + 1j * rng.standard_normal((512, 512))).astype(np.complex64)
    assert _rel(ftt.device_get_complex(ftt.fft2(x2)), np.fft.fft2(x2)) < TOL
    xr = rng.standard_normal((128, 4096)).astype(np.float32)
    assert _rel(ftt.device_get_complex(ftt.rfft(xr)),
                np.fft.rfft(xr, axis=-1)) < TOL


def test_plan_parity_two_pass(ftt, rng):
    """Onlyinverse + Normalize two-pass (reference basic_inverse2.rs)."""
    x = (rng.standard_normal((32, 2048))
         + 1j * rng.standard_normal((32, 2048))).astype(np.complex64)
    p = ftt.plan(2048)
    X = p.forward(x)
    back = p.normalize(p.inverse_unnormalized(X))
    assert _rel(ftt.device_get_complex(back), x) < TOL


def test_non_pow2_and_prime(ftt, rng):
    for n in (1000, 997):
        x = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
             ).astype(np.complex64)
        assert _rel(ftt.device_get_complex(ftt.fft(x)),
                    np.fft.fft(x, axis=-1)) < TOL, f"n={n}"


def test_donated_plan_invalidates_and_computes(ftt, rng):
    """donate=True plans (the reference's in-place ping-pong analogue)
    compute correctly on the card.  The complex-facade executor cannot
    alias its two float32 inputs into one complex64 output, so XLA
    declines that donation with a warning and the inputs stay valid;
    the split-domain form does alias (test_split_donation_truly_aliases
    below checks the invalidation)."""
    import jax
    import jax.numpy as jnp

    p = ftt.plan(2048, donate=True)
    with pytest.warns(UserWarning, match="donated buffers were not usable"):
        p.warmup((32,))
    re = jnp.ones((32, 2048), jnp.float32)
    im = jnp.zeros((32, 2048), jnp.float32)
    X = p._jitted(-1, -1, None)(re, im)
    got = np.asarray(jax.jit(jnp.real)(X)[:, 0])
    assert np.allclose(got, 2048.0, atol=1e-2)  # FFT of ones: DC bin = n
    assert not re.is_deleted(), "declined donation must leave inputs valid"


def test_c2r_and_dct_fast_paths(ftt, rng):
    x = rng.standard_normal((64, 4096)).astype(np.float32)
    X = np.fft.rfft(x, axis=-1).astype(np.complex64)
    back = ftt.irfft(ftt.device_put_complex(X), n=4096, axis=-1)
    assert _rel(np.asarray(back), x) < TOL
    sfft = pytest.importorskip("scipy.fft")
    d = ftt.dct(x[:32, :1024], type=1, norm="ortho")
    assert _rel(np.asarray(d), sfft.dct(x[:32, :1024], type=1,
                                        norm="ortho")) < TOL


def test_single_row_2e18(ftt, rng):
    """2^18 single row through ftt.fft end to end."""
    n = 1 << 18
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    Z = ftt.device_get_complex(ftt.fft(z))
    assert _rel(Z, np.fft.fft(z)) < TOL


def test_split_donation_truly_aliases(ftt, rng):
    """forward_split with donate=True: f32-in/f32-out lets XLA alias the
    donated buffers (no 'donated buffers not usable' path)."""
    import jax.numpy as jnp

    p = ftt.plan(1024, donate=True)
    re = jnp.ones((32, 1024), jnp.float32)
    im = jnp.zeros((32, 1024), jnp.float32)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # unusable donation would warn
        Xr, Xi = p.forward_split(re, im)
    assert re.is_deleted() and im.is_deleted()
    assert np.allclose(np.asarray(Xr[:, 0]), 1024.0, atol=1e-2)


def test_grad_through_plan_on_gpu(ftt, rng):
    """jax.grad through the plan's executor: compare against the analytic
    adjoint (sign-flipped transform of the cotangent), all on device."""
    import jax
    import jax.numpy as jnp

    n = 2048
    p = ftt.plan(n)
    re = jnp.asarray(rng.standard_normal((16, n)).astype(np.float32))
    im = jnp.asarray(rng.standard_normal((16, n)).astype(np.float32))
    wr = jnp.asarray(rng.standard_normal((16, n)).astype(np.float32))
    wi = jnp.asarray(rng.standard_normal((16, n)).astype(np.float32))

    @jax.jit
    def gfn(a, b):
        def loss(a, b):
            Xr, Xi = p._execute_split(a, b, -1, None)
            return jnp.sum(Xr * wr + Xi * wi)

        return jax.grad(loss, argnums=(0, 1))(a, b)

    gr, gi = gfn(re, im)
    # analytic adjoint: +sign transform of the cotangent (wr, wi)
    ar, ai = jax.jit(lambda a, b: p._execute_split(a, b, +1, None))(wr, wi)
    num = float(jnp.sqrt(jnp.sum((gr - ar) ** 2 + (gi - ai) ** 2)))
    den = float(jnp.sqrt(jnp.sum(ar ** 2 + ai ** 2)))
    assert num / den < TOL


def test_spectral_filter(ftt, rng):
    """Filter loop matches numpy on the card."""
    import numpy as np

    n = 4096
    x = (rng.standard_normal((64, n)) + 1j * rng.standard_normal((64, n))
         ).astype(np.complex64)
    H = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    f = ftt.SpectralFilter(H)
    got = np.asarray(ftt.device_get_complex(f(x)))
    want = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    assert _rel(got, want) < TOL


def test_aot_artifact_replays_on_gpu(ftt, rng, tmp_path):
    # serving path: export a plan artifact, load it in-process, and
    # replay forward/inverse on the card with zero re-tracing.  jax's
    # artifact serialization needs the optional flatbuffers package
    pytest.importorskip("flatbuffers", reason="jax.export serialization "
                        "needs flatbuffers")
    p = ftt.plan(512)
    path = str(tmp_path / "fft512.ftta")
    ftt.export_plan(p, path, batch_shape=(64,))

    sp = ftt.load_plan(path)
    x = (rng.standard_normal((64, 512))
         + 1j * rng.standard_normal((64, 512))).astype(np.complex64)
    import jax.numpy as jnp
    re = jnp.asarray(x.real.astype(np.float32))
    im = jnp.asarray(x.imag.astype(np.float32))
    Xr, Xi = sp.forward_split(re, im)
    want = np.fft.fft(x, axis=-1)
    got = np.asarray(Xr) + 1j * np.asarray(Xi)
    assert _rel(got, want) < TOL

    rr, ri = sp.inverse_split(Xr, Xi)
    assert _rel(np.asarray(rr) + 1j * np.asarray(ri), x) < TOL

    # wrong shape fails clearly, not with a tracing error
    with pytest.raises(ValueError):
        sp.forward_split(re[:32], im[:32])


def test_ragged_batches(ftt, rng):
    """Batches that are no power of two, through fft, rfft and irfft, and
    a ragged extent on a non-minor axis."""
    n = 512
    for rows in (300, 400):
        x = (rng.standard_normal((rows, n))
             + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
        assert _rel(ftt.device_get_complex(ftt.fft(x)),
                    np.fft.fft(x, axis=-1)) < TOL, f"fft rows={rows}"
        r = rng.standard_normal((rows, n)).astype(np.float32)
        assert _rel(ftt.device_get_complex(ftt.rfft(r)),
                    np.fft.rfft(r, axis=-1)) < TOL, f"rfft rows={rows}"
        spec = np.fft.rfft(r, axis=-1).astype(np.complex64)
        sr = ftt.utils.io.device_put_complex(spec)
        assert _rel(np.asarray(ftt.irfft(sr)),
                    r) < TOL, f"irfft rows={rows}"
    y = (rng.standard_normal((n, 300))
         + 1j * rng.standard_normal((n, 300))).astype(np.complex64)
    assert _rel(ftt.device_get_complex(ftt.fft(y, axis=0)),
                np.fft.fft(y, axis=0)) < TOL, "fft axis=0 m=300"


def test_composite_n(ftt, rng):
    x = (rng.standard_normal((64, 1000))
         + 1j * rng.standard_normal((64, 1000))).astype(np.complex64)
    assert _rel(ftt.device_get_complex(ftt.fft(x)),
                np.fft.fft(x, axis=-1)) < TOL


def test_prime_n(ftt, rng):
    x = (rng.standard_normal((32, 521))
         + 1j * rng.standard_normal((32, 521))).astype(np.complex64)
    assert _rel(ftt.device_get_complex(ftt.fft(x)),
                np.fft.fft(x, axis=-1)) < TOL


def test_czt(ftt, rng):
    import scipy.signal as sig

    x = (rng.standard_normal((16, 700))
         + 1j * rng.standard_normal((16, 700))).astype(np.complex64)
    got = ftt.device_get_complex(ftt.czt(x, m=450))
    want = sig.czt(np.asarray(x, np.complex128), m=450)
    assert _rel(got, want) < 1e-4
