"""Aux subsystems: validation harness, roofline math, profiling stats."""

import pytest

from fft_wgpu_tpu.utils import debug, profiling, roofline


def test_validate_kernel():
    err = debug.validate_kernel(512, batch=2)
    assert err < 1e-5
    err = debug.validate_kernel(1024, batch=2, sign=+1)
    assert err < 1e-5


def test_check_finite():
    import jax.numpy as jnp
    from jax.experimental import checkify

    f = checkify.checkify(lambda r, i: debug.check_finite(r, i, "unit"))
    err, _ = f(jnp.ones(4), jnp.ones(4))
    err.throw()  # no error
    err, _ = f(jnp.array([1.0, jnp.nan]), jnp.ones(2))
    with pytest.raises(Exception):
        err.throw()


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


H100 = _Dev("NVIDIA H100 80GB HBM3")


def test_roofline_math():
    r = roofline.roofline(4096, 4096, seconds=1.0, device=H100)
    assert r["roofline_gflops"] > 0
    assert r["bandwidth"] == 3.35e12
    # one read + one write of complex64
    assert abs(r["t_min_s"] - 2 * 4096 * 4096 * 8 / 3.35e12) < 1e-15
    assert abs(roofline.fft_flops(1024) - 5 * 1024 * 10) < 1e-6


@pytest.mark.parametrize("kind,hbm", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
])
def test_h100_kinds_resolve(kind, hbm):
    assert roofline.hbm_bandwidth(_Dev(kind)) == hbm


def test_link_bandwidth():
    assert roofline.link_bandwidth(H100) == 4.5e11
    with pytest.raises(ValueError):
        roofline.link_bandwidth(_Dev("NVIDIA H100 PCIe"))


@pytest.mark.parametrize("kind", ["cpu", "Unknown Accel 9", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100"])
def test_unknown_kind_raises(kind):
    with pytest.raises(ValueError):
        roofline.hbm_bandwidth(_Dev(kind))


def test_unknown_default_device_raises():
    # the tests run on the CPU backend, which has no published peak
    with pytest.raises(ValueError):
        roofline.hbm_bandwidth()


def test_op_stats():
    s = profiling.op_stats(4096, 4096, 0.001, device=H100)
    assert s["gflops"] > 0 and 0 < s["roofline_fraction"]
    assert s["flops_per_element"] == 5 * 12


@pytest.mark.parametrize("events,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 20), (30, 40)], 30.0),
    ([(30, 40), (0, 10), (2, 3)], 20.0),
])
def test_busy_ns_is_interval_union(events, want):
    assert profiling.busy_ns(events) == want


def test_split_calls_at_widest_gaps():
    ev = [("a", 0, 10), ("b", 12, 20), ("c", 100, 110), ("d", 111, 115),
          ("e", 300, 301)]
    calls = profiling.split_calls(ev[::-1], 3)
    assert [[e[0] for e in c] for c in calls] == [["a", "b"], ["c", "d"],
                                                  ["e"]]
    with pytest.raises(RuntimeError):
        profiling.split_calls(ev[:2], 3)


def test_device_times_refuses_host_only_trace():
    """On the CPU backend the trace has no device plane: device_times
    raises instead of falling back to a host clock."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a: a * 2)
    with pytest.raises(RuntimeError):
        profiling.device_times(f, (jnp.ones(8),), calls=2)


def test_compile_cache_dir_default(monkeypatch):
    import os

    import jax

    from fft_wgpu_tpu.utils import io

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        p = io.enable_persistent_compilation_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert p == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == p
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    import jax

    from fft_wgpu_tpu.utils import io

    want = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert io.enable_persistent_compilation_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
