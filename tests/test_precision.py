"""Public dot-precision control (utils/precision.py).

On CPU both modes produce f32 dots, so these tests check the plumbing
(mode reaches the recursion's precision, caches flush, results stay
correct); the TF32 error of "fast" on the GPU is measured by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.ops import stockham as st


def test_mode_plumbing():
    import jax

    assert ftt.get_dot_precision() == "accurate"
    assert st._DOT_PREC == jax.lax.Precision.HIGHEST
    try:
        ftt.set_dot_precision("fast")
        assert ftt.get_dot_precision() == "fast"
        assert st._DOT_PREC == jax.lax.Precision.DEFAULT
        # transforms still work and are CPU-exact in this mode
        x = np.random.default_rng(0).standard_normal((4, 256)) \
            .astype(np.float32)
        got = np.asarray(jnp.real(ftt.fft(x))) \
            + 1j * np.asarray(jnp.imag(ftt.fft(x)))
        ref = np.fft.fft(x, axis=-1)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
    finally:
        ftt.set_dot_precision("accurate")
    assert st._DOT_PREC == jax.lax.Precision.HIGHEST


def test_context_manager_restores():
    with ftt.dot_precision("fast"):
        assert ftt.get_dot_precision() == "fast"
    assert ftt.get_dot_precision() == "accurate"
    with pytest.raises(ValueError):
        ftt.set_dot_precision("wat")


def test_jit_cache_retraces_after_mode_switch():
    """The convenience-API jit cache (utils/jit_cache) stores jitted
    wrappers across calls; set_dot_precision relies on jax.clear_caches()
    reaching INTO those stored wrappers so a cached welch/dct/fft entry
    retraces under the new _DOT_PREC.  Pin that: if a jax upgrade ever
    stops clear_caches from flushing live pjit wrappers, "fast" mode
    would silently not apply to cached entry points."""
    from fft_wgpu_tpu.utils.jit_cache import cached_call

    traces = []

    def impl(x):
        traces.append(1)
        return x * 2

    key = ("precision-retrace-pin",)
    x = jnp.ones((4,), jnp.float32)
    cached_call(key, impl, x)
    cached_call(key, impl, x)
    assert len(traces) == 1, "cache failed: second call retraced"
    try:
        ftt.set_dot_precision("fast")  # calls jax.clear_caches()
        cached_call(key, impl, x)
        assert len(traces) == 2, (
            "set_dot_precision did not flush the stored jit wrapper — "
            "fast mode would not reach cached convenience functions")
    finally:
        ftt.set_dot_precision("accurate")


@pytest.mark.parametrize("mode", ["accurate", "fast"])
def test_recursion_within_stated_tolerance(mode):
    """Each mode's stated rel-L2 bound holds for the matmul recursion
    (on the CPU both are full f32, so this checks the bound's plumbing;
    on an H100 "fast" is TF32)."""
    from fft_wgpu_tpu.utils.precision import TOLERANCE

    x = (np.random.default_rng(1).standard_normal((4, 4096))
         + 1j * np.random.default_rng(2).standard_normal((4, 4096))
         ).astype(np.complex64)
    with ftt.dot_precision(mode):
        got = ftt.device_get_complex(
            ftt.plan(4096, executor="xla").forward(x))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= TOLERANCE[mode]
