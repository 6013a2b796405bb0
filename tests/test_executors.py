"""Every executor a plan accepts, swept over lengths, axes, batch shapes
and norms against numpy and the f64 naive DFT, plus the N-D and real
transforms through `lax.fft`'s types."""

import numpy as np
import pytest

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.plan.plan import Plan

EXECUTORS = ["lax", "xla", "fourstep", "direct"]


def crand(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("n", [1, 2, 3, 16, 97, 128, 360, 512, 1000, 1031])
def test_length_sweep_vs_naive_dft(executor, n, rng, assert_close):
    if executor == "direct" and n > 512:
        n = 509  # keep the dense DFT matrix small; still prime
    x = crand(rng, 3, n)
    got = ftt.device_get_complex(Plan(n, executor=executor).forward(x))
    assert_close(got, ftt.naive_dft(x.astype(np.complex128)),
                 what=f"{executor} n={n}")


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("shape,axis", [
    ((64,), -1), ((64, 5), 0), ((4, 6, 64), -1), ((64, 3, 5), 0),
    ((3, 64, 5), 1),
])
def test_axis_and_batch_sweep(executor, shape, axis, rng, assert_close):
    x = crand(rng, *shape)
    p = Plan(64, executor=executor)
    assert_close(ftt.device_get_complex(p.forward(x, axis=axis)),
                 np.fft.fft(x, axis=axis), what=f"{executor} {shape}")
    assert_close(ftt.device_get_complex(p.inverse(x, axis=axis)),
                 np.fft.ifft(x, axis=axis), what=f"{executor} {shape} inv")


@pytest.mark.parametrize("executor", ["auto", "xla", "fourstep"])
@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_norm_sweep(executor, norm, rng, assert_close):
    x = crand(rng, 4, 240)
    assert_close(ftt.fft(x, norm=norm, executor=executor),
                 np.fft.fft(x, norm=norm))
    assert_close(ftt.ifft(x, norm=norm, executor=executor),
                 np.fft.ifft(x, norm=norm))


@pytest.mark.parametrize("executor", EXECUTORS)
def test_unnormalized_inverse_and_normalize(executor, rng, assert_close):
    x = crand(rng, 8, 96)
    p = Plan(96, executor=executor)
    X = p.forward(x)
    assert_close(ftt.device_get_complex(p.inverse_unnormalized(X)),
                 96 * x.astype(np.complex128))
    assert_close(ftt.device_get_complex(
        p.normalize(p.inverse_unnormalized(X))), x)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_split_domain_matches_complex_facade(executor, rng):
    import jax.numpy as jnp

    x = crand(rng, 4, 100)
    p = Plan(100, executor=executor)
    Xr, Xi = p.forward_split(jnp.asarray(x.real), jnp.asarray(x.imag))
    Z = ftt.device_get_complex(p.forward(x))
    got = np.asarray(Xr) + 1j * np.asarray(Xi)
    assert np.linalg.norm(got - Z) / np.linalg.norm(Z) < 1e-6


@pytest.mark.parametrize("shape,axes", [
    ((8, 12), None), ((6, 8, 10), None), ((4, 6, 8, 10), None),
    ((4, 6, 8, 10), (0, 1, 2, 3)), ((6, 8, 10), (0, 2)),
    ((6, 8, 10), (2, 0)), ((5, 6, 7), (1,)), ((3, 4, 5, 6, 7), (0, 2, 4)),
])
def test_fftn_lax_chunks(shape, axes, rng, assert_close):
    """N-D transforms group up to 3 axes per lax.fft call, in any order
    and position, with the others as batch."""
    x = crand(rng, *shape)
    assert_close(ftt.fftn(x, axes=axes), np.fft.fftn(x, axes=axes))
    assert_close(ftt.ifftn(x, axes=axes, norm="ortho"),
                 np.fft.ifftn(x, axes=axes, norm="ortho"))


def test_fftn_repeated_axis(rng, assert_close):
    """numpy applies a repeated axis twice; so does the lax route."""
    x = crand(rng, 6, 8)
    assert_close(ftt.fftn(x, axes=(1, 1)), np.fft.fftn(x, axes=(1, 1)))


@pytest.mark.parametrize("executor", ["lax", "xla", "fourstep"])
def test_fft2_executor_override(executor, rng, assert_close):
    x = crand(rng, 3, 24, 40)
    assert_close(ftt.fft2(x, executor=executor), np.fft.fft2(x))


def test_lax_chunks_grouping():
    from fft_wgpu_tpu.ops.nd import _lax_chunks

    assert _lax_chunks([0, 1, 2]) == [[0, 1, 2]]
    assert _lax_chunks([0, 1, 2, 3]) == [[1, 2, 3], [0]]
    assert _lax_chunks([1, 1]) == [[1], [1]]


@pytest.mark.parametrize("shape,s,axes", [
    ((8, 16), None, None), ((8, 15), None, None), ((4, 6, 10), None, None),
    ((4, 6, 10), (4, 7), (0, 2)), ((6, 9), (6, 16), None),
])
def test_rfftn_irfftn_lax_types(shape, s, axes, rng, assert_close):
    x = rng.standard_normal(shape).astype(np.float32)
    X = ftt.rfftn(x, s=s, axes=axes)
    want = np.fft.rfftn(x, s=s, axes=axes)
    assert_close(X, want)
    back = ftt.irfftn(ftt.device_get_complex(X), s=s, axes=axes)
    assert_close(back, np.fft.irfftn(want, s=s, axes=axes))
