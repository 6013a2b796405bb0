"""R2C / C2R transforms vs numpy (new capability vs the C2C-only reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fft_wgpu_tpu as ftt


@pytest.mark.parametrize("n", [2, 4, 16, 256, 512, 1024, 120])
def test_rfft_matches_numpy(n, rng, assert_close):
    x = rng.standard_normal((4, n)).astype(np.float32)
    assert_close(ftt.rfft(x), np.fft.rfft(x, axis=-1), what=f"(n={n})")


@pytest.mark.parametrize("n", [15, 33])
def test_rfft_odd_fallback(n, rng, assert_close):
    x = rng.standard_normal(n).astype(np.float32)
    assert_close(ftt.rfft(x), np.fft.rfft(x), what=f"(n={n})")


@pytest.mark.parametrize("n", [4, 256, 1024, 120])
def test_irfft_matches_numpy(n, rng, assert_close):
    X = (rng.standard_normal((3, n // 2 + 1)) + 1j * rng.standard_normal((3, n // 2 + 1))).astype(np.complex64)
    assert_close(ftt.irfft(X, n=n), np.fft.irfft(X, n=n, axis=-1), what=f"(n={n})")


def test_rfft_irfft_roundtrip(rng, assert_close):
    x = rng.standard_normal((2, 512)).astype(np.float32)
    assert_close(ftt.irfft(ftt.rfft(x), n=512), x)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_rfft_norms(norm, rng, assert_close):
    x = rng.standard_normal(256).astype(np.float32)
    assert_close(ftt.rfft(x, norm=norm), np.fft.rfft(x, norm=norm or "backward"))
    X = np.fft.rfft(x)
    assert_close(
        ftt.irfft(X.astype(np.complex64), n=256, norm=norm),
        np.fft.irfft(X, n=256, norm=norm or "backward"),
    )


def test_rfft_axis(rng, assert_close):
    x = rng.standard_normal((8, 64, 3)).astype(np.float32)
    assert_close(ftt.rfft(x, axis=1), np.fft.rfft(x, axis=1))
    X = np.fft.rfft(x, axis=1).astype(np.complex64)
    assert_close(ftt.irfft(X, n=64, axis=1), np.fft.irfft(X, n=64, axis=1))


def test_rfft2_and_rfftn(rng, assert_close):
    x = rng.standard_normal((32, 64)).astype(np.float32)
    assert_close(ftt.rfft2(x), np.fft.rfft2(x))
    assert_close(ftt.irfft2(ftt.rfft2(x), s=(32, 64)), x)
    y = rng.standard_normal((8, 16, 32)).astype(np.float32)
    assert_close(ftt.rfftn(y), np.fft.rfftn(y))
    assert_close(ftt.irfftn(ftt.rfftn(y), s=(8, 16, 32)), y)


def test_rfft_rejects_complex(rng):
    z = (rng.standard_normal(16) + 1j * rng.standard_normal(16)).astype(np.complex64)
    with pytest.raises(TypeError):
        ftt.rfft(z)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hfft_ihfft(norm, rng, assert_close):
    n = 256
    X = (rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(n // 2 + 1)).astype(np.complex64)
    assert_close(ftt.hfft(X, n=n, norm=norm), np.fft.hfft(X, n=n, norm=norm or "backward"))
    x = rng.standard_normal(n).astype(np.float32)
    assert_close(ftt.ihfft(x, norm=norm), np.fft.ihfft(x, norm=norm or "backward"))


@pytest.mark.parametrize("n,rows,scale", [
    (1024, 4, None), (512, 130, None), (1024, 8, 1024**-0.5),
    (1000, 3, None), (4095, 2, None), (7, 5, 0.5), (1, 2, None),
    (4093, 2, None),
])
def test_rfft_last_split_matches_numpy(n, rows, scale, rng, assert_close):
    """R2C through lax's RFFT for even, odd, prime and length-1 rows."""
    from fft_wgpu_tpu.ops.rfft import rfft_last_split

    x = rng.standard_normal((rows, n)).astype(np.float32)
    Xr, Xi = jax.jit(lambda v: rfft_last_split(v, scale))(jnp.asarray(x))
    want = np.fft.rfft(x, axis=-1) * (1.0 if scale is None else scale)
    assert Xr.shape == (rows, n // 2 + 1)
    assert_close(np.asarray(Xr) + 1j * np.asarray(Xi), want,
                 what=f"r2c n={n}")


@pytest.mark.parametrize("n,rows", [
    (256, 4), (1024, 3), (2048, 130), (15, 4), (1001, 2), (2, 3),
])
@pytest.mark.parametrize("scale", [None, "backward"])
def test_irfft_last_split_matches_numpy(n, rows, scale, rng, assert_close):
    """C2R through lax's IRFFT with an explicit total output scale; the
    imaginary parts of DC (and Nyquist for even n) are discarded."""
    from fft_wgpu_tpu.ops.rfft import irfft_last_split

    X = (rng.standard_normal((rows, n // 2 + 1))
         + 1j * rng.standard_normal((rows, n // 2 + 1))).astype(np.complex64)
    total = None if scale is None else 1.0 / n
    out = jax.jit(lambda a, b: irfft_last_split(a, b, n, total))(
        jnp.asarray(X.real), jnp.asarray(X.imag))
    want = np.fft.irfft(X, n=n, axis=-1) * (n if scale is None else 1.0)
    assert out.shape == (rows, n)
    assert_close(np.asarray(out), want, what=f"c2r n={n}")


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("shape,s,axes", [
    ((3, 9), None, None),        # default: last axis Hermitian, n=2*(9-1)
    ((4, 5), (4, 11), None),     # odd output length
    ((6, 3, 5), None, (0, 2)),   # explicit axes, Hermitian on axis 2
    ((5, 4), (8,), (0,)),        # single Hermitian axis only
])
def test_hfftn_matches_scipy(shape, s, axes, norm, rng, assert_close):
    import scipy.fft as sf

    X = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want = sf.hfftn(X.copy(), s=s, axes=axes, norm=norm)
    assert_close(ftt.hfftn(X, s=s, axes=axes, norm=norm), want,
                 what=f"(shape={shape}, s={s}, axes={axes}, norm={norm})")


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("shape,s,axes", [
    ((3, 16), None, None),
    ((4, 3, 10), None, (0, 2)),
    ((5, 12), (4, 8), None),
])
def test_ihfftn_matches_scipy(shape, s, axes, norm, rng, assert_close):
    import scipy.fft as sf

    x = rng.standard_normal(shape).astype(np.float32)
    want = sf.ihfftn(x, s=s, axes=axes, norm=norm).astype(np.complex64)
    assert_close(ftt.ihfftn(x, s=s, axes=axes, norm=norm), want,
                 what=f"(shape={shape}, s={s}, axes={axes}, norm={norm})")


def test_hfft2_roundtrip(rng, assert_close):
    import scipy.fft as sf

    x = rng.standard_normal((6, 10)).astype(np.float32)
    Z = ftt.ihfft2(x)
    assert_close(Z, sf.ihfft2(x).astype(np.complex64))
    assert_close(ftt.hfft2(np.asarray(ftt.device_get_complex(Z)), s=x.shape), x)
