"""Plan layer + reference-parity class API (SURVEY §2 C4-C11)."""

import numpy as np
import pytest

import fft_wgpu_tpu as ftt


def crand(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def test_plan_constructed_once_used_many(rng, assert_close):
    p = ftt.plan(512)
    for _ in range(3):
        x = crand(rng, 4, 512)
        assert_close(p.forward(x), np.fft.fft(x, axis=-1))
        assert_close(p.inverse(x), np.fft.ifft(x, axis=-1))


def test_plan_validates_length(rng):
    p = ftt.plan(256)
    with pytest.raises(ValueError):
        p.forward(crand(rng, 128))
    with pytest.raises(ValueError):
        ftt.plan(0)
    with pytest.raises(ValueError):
        ftt.plan(16, executor="nope")


def test_plan_inverse_unnormalized_and_normalize(rng, assert_close):
    p = ftt.plan(512)
    x = crand(rng, 512)
    assert_close(p.inverse_unnormalized(x), np.fft.ifft(x) * 512)
    assert_close(p.normalize(p.inverse_unnormalized(x)), np.fft.ifft(x))


def test_parity_classes(rng, assert_close):
    # Reference-shaped flow: Forward::new(...,512) then proc per iteration
    # (examples/basic.rs:66-127).
    n = 512
    x = crand(rng, 8, n)
    fwd, inv = ftt.Forward(n), ftt.Inverse(n)
    only, nrm = ftt.Onlyinverse(n), ftt.Normalize(n)
    assert_close(fwd.proc(x), np.fft.fft(x, axis=-1))
    assert_close(inv.proc(x), np.fft.ifft(x, axis=-1))
    # Two-pass composition (examples/basic_inverse2.rs:85-92): one jit =
    # one "command encoder".
    import jax

    two_pass = jax.jit(lambda v: nrm.proc(only.proc(v)))
    assert_close(two_pass(x), np.fft.ifft(x, axis=-1))


def test_executor_override_xla_matches_direct(rng, assert_close):
    x = crand(rng, 256)
    a = ftt.fft(x, executor="xla")
    b = ftt.fft(x, executor="direct")
    assert_close(a, b, tol=1e-5)
    assert_close(a, np.fft.fft(x))


def test_plan_warmup_aot(rng, assert_close):
    p = ftt.plan(256).warmup(batch_shape=(4,))
    x = crand(rng, 4, 256)
    assert_close(p.forward(x), np.fft.fft(x, axis=-1))


def test_plan_dtype_validated():
    import jax.numpy as jnp
    import pytest as _pytest

    assert ftt.plan(256, dtype=jnp.complex64).dtype == jnp.complex64
    with _pytest.raises(ValueError, match="unsupported dtype"):
        ftt.plan(256, dtype=jnp.complex128)
    with _pytest.raises(ValueError, match="unsupported dtype"):
        ftt.plan(256, dtype=jnp.float32)


def test_plan_donate_zero_alloc_replay(rng, assert_close):
    # Mirrors the reference's caller-owned in-place ping-pong buffers
    # (processor.rs:580-586): with donate=True the jitted executor reuses
    # the donated input HBM, and the donated arrays are invalidated.
    import jax
    import jax.numpy as jnp

    p = ftt.plan(512, donate=True)
    x = crand(rng, 32, 512)
    want = np.fft.fft(x, axis=-1)
    re = jnp.asarray(np.ascontiguousarray(x.real))
    im = jnp.asarray(np.ascontiguousarray(x.imag))
    fn = p._jitted(-1, -1, None)
    out = fn(re, im)
    assert_close(out, want)
    # Whether XLA actually reuses a donated buffer is backend/layout
    # dependent (CPU often declines); assert the donation CONTRACT on the
    # lowered executable — actual reuse is checked on the GPU
    # (tests/test_gpu.py).
    info, _ = fn.lower(re, im).args_info
    assert all(a.donated for a in info), "executors must donate (re, im)"
    # a non-donating plan must not donate
    fn2 = ftt.plan(512)._jitted(-1, -1, None)
    info2, _ = fn2.lower(re, im).args_info
    assert not any(a.donated for a in info2)
    # plan replay with fresh buffers still works
    assert_close(p.forward(x), want)


@pytest.mark.parametrize("executor", ["auto", "lax", "xla", "fourstep",
                                      "direct"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_executor_override_matches_numpy(executor, axis, rng, assert_close):
    """Every executor a plan accepts computes the same transform, along
    the minor axis and a non-minor one."""
    x = (rng.standard_normal((96, 96)) + 1j * rng.standard_normal((96, 96))
         ).astype(np.complex64)
    p = ftt.plan(96, executor=executor)
    assert_close(ftt.device_get_complex(p.forward(x, axis=axis)),
                 np.fft.fft(x, axis=axis), what=executor)
    assert_close(ftt.device_get_complex(p.inverse(x, axis=axis)),
                 np.fft.ifft(x, axis=axis), what=executor)


def test_split_domain_plan_methods(rng):
    """forward_split/inverse_split: the zero-copy serving form (same-dtype
    in/out so donate=True can truly alias buffers)."""
    import jax.numpy as jnp
    import numpy as np

    from fft_wgpu_tpu.plan.plan import Plan

    x = (rng.standard_normal((16, 512)) + 1j * rng.standard_normal((16, 512))
         ).astype(np.complex64)
    p = Plan(512)
    Xr, Xi = p.forward_split(jnp.asarray(x.real), jnp.asarray(x.imag))
    ref = np.fft.fft(x, axis=-1)
    err = np.linalg.norm((np.asarray(Xr) + 1j * np.asarray(Xi)) - ref)
    assert err / np.linalg.norm(ref) < 1e-5
    rr, ri = p.inverse_split(Xr, Xi)
    rt = np.linalg.norm((np.asarray(rr) + 1j * np.asarray(ri)) - x)
    assert rt / np.linalg.norm(x) < 1e-5
    ur, ui = p.inverse_unnormalized_split(Xr, Xi)
    assert np.allclose(np.asarray(ur), np.asarray(rr) * 512, rtol=1e-4)

    # donate=True: same math; on CPU donation is declined (buffers live)
    pd = Plan(512, donate=True)
    a, b = jnp.asarray(x.real), jnp.asarray(x.imag)
    Yr, Yi = pd.forward_split(a, b)
    err = np.linalg.norm((np.asarray(Yr) + 1j * np.asarray(Yi)) - ref)
    assert err / np.linalg.norm(ref) < 1e-5


class TestCLI:
    def test_info_and_selftest(self, capsys):
        from fft_wgpu_tpu.__main__ import main
        import json

        assert main(["info"]) == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        d = json.loads(out)
        assert d["backend"] and d["device_count"] >= 1
        assert main(["selftest", "--n", "256"]) == 0

    def test_tune_subcommand_removed(self, capsys):
        from fft_wgpu_tpu.__main__ import main

        with pytest.raises(SystemExit):
            main(["tune", "1024"])

    def test_export_plan_cli(self, tmp_path):
        from fft_wgpu_tpu.__main__ import main

        out = str(tmp_path / "p.ftt")
        assert main(["export-plan", "128", out, "--batch", "4"]) == 0
        import os

        assert os.path.getsize(out) > 0
