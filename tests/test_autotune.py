"""Autotuned executor selection (plan(n, autotune=True) — FFTW_MEASURE
analogue): candidate enumeration, caching, wisdom persistence and the
executor names a plan accepts."""

import json

import numpy as np
import pytest

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.plan import autotune
from fft_wgpu_tpu.plan.plan import EXECUTORS, Plan

REMOVED = ("pallas", "pallas:classic", "pallas:dit", "pallas:balanced",
           "bigfft", "pallas:bogus")


class TestCandidates:
    @pytest.mark.parametrize("n,rows,want", [
        (4096, 4096, ["lax", "xla", "fourstep"]),
        (4095, 64, ["lax", "xla", "fourstep"]),
        (1 << 20, 1, ["lax", "xla", "fourstep"]),
        (4093, 8, ["lax", "xla"]),          # prime: four-step cannot split
        (2, 1, ["lax", "xla"]),             # 2 = 1 x 2: nothing to split
    ])
    def test_candidates(self, n, rows, want):
        assert autotune.candidates_for(n, rows) == want

    @pytest.mark.parametrize("n", [1, 7, 512, 1000, 4093, 1 << 22])
    def test_candidates_are_accepted_executors(self, n):
        for ex in autotune.candidates_for(n, 8):
            assert ex in EXECUTORS and ex != "auto"
            assert ex not in REMOVED


class TestMeasureCaching:
    def test_picks_fastest_and_caches(self, monkeypatch):
        autotune.TUNE_CACHE.clear()
        monkeypatch.setattr(autotune, "_wisdom_loaded", True)
        monkeypatch.setattr(autotune, "save_wisdom", lambda *a, **k: None)
        times = {"lax": 3.0, "xla": 1.0, "fourstep": 2.0}
        measured = []

        def fake_slope(fn, shape, **kw):
            # identify the candidate through the closure default
            ex = fn.__defaults__[0]
            measured.append(ex)
            return times[ex]

        monkeypatch.setattr(autotune, "_slope_time", fake_slope)
        p = Plan(16384, autotune=True)
        ex = autotune.measure_executor(p, (256, 16384), -1)
        assert ex == "xla"
        assert set(measured) == {"lax", "xla", "fourstep"}
        measured.clear()
        assert autotune.measure_executor(p, (256, 16384), -1) == "xla"
        assert not measured  # cached
        autotune.TUNE_CACHE.clear()

    def test_failed_candidate_skipped(self, monkeypatch):
        autotune.TUNE_CACHE.clear()
        monkeypatch.setattr(autotune, "_wisdom_loaded", True)
        monkeypatch.setattr(autotune, "save_wisdom", lambda *a, **k: None)

        def fake_slope(fn, shape, **kw):
            ex = fn.__defaults__[0]
            if ex == "lax":
                raise RuntimeError("does not compile")
            return {"xla": 2.0, "fourstep": 1.0}[ex]

        monkeypatch.setattr(autotune, "_slope_time", fake_slope)
        p = Plan(4096, autotune=True)
        ex = autotune.measure_executor(p, (512, 4096), -1)
        assert ex == "fourstep"
        autotune.TUNE_CACHE.clear()

    def test_rows_bucket_separates_regimes(self, monkeypatch):
        autotune.TUNE_CACHE.clear()
        monkeypatch.setattr(autotune, "_wisdom_loaded", True)
        monkeypatch.setattr(autotune, "save_wisdom", lambda *a, **k: None)
        calls = []
        monkeypatch.setattr(
            autotune, "_slope_time",
            lambda fn, shape, **k: calls.append(shape) or 1.0)
        p = Plan(256, autotune=True)
        autotune.measure_executor(p, (1, 256), -1)
        autotune.measure_executor(p, (8, 256), -1)
        autotune.measure_executor(p, (4096, 256), -1)
        autotune.measure_executor(p, (2048, 256), -1)  # same bucket: cached
        assert len({k[2] for k in autotune.TUNE_CACHE}) == 3
        assert len(calls) == 3 * len(autotune.candidates_for(256, 8))
        autotune.TUNE_CACHE.clear()


class TestPlanIntegration:
    def test_autotune_plan_correct_on_cpu(self, rng, monkeypatch):
        monkeypatch.setattr(autotune, "save_wisdom", lambda *a, **k: None)
        monkeypatch.setattr(autotune, "_wisdom_loaded", True)
        x = (rng.standard_normal((8, 512))
             + 1j * rng.standard_normal((8, 512))).astype(np.complex64)
        p = ftt.plan(512, autotune=True)
        got = np.asarray(ftt.device_get_complex(p.forward(x)))
        np.testing.assert_allclose(got, np.fft.fft(x, axis=-1), rtol=2e-5,
                                   atol=2e-4)
        # the measured winner is cached for this (backend, n, rows, axis)
        hits = [v for k, v in autotune.TUNE_CACHE.items() if k[1] == 512]
        assert hits and hits[0] in autotune.candidates_for(512, 8)
        autotune.TUNE_CACHE.clear()

    @pytest.mark.parametrize("ex", EXECUTORS)
    def test_executor_names_accepted(self, ex):
        assert ftt.plan(1024, executor=ex).executor == ex

    @pytest.mark.parametrize("ex", REMOVED)
    def test_removed_executor_rejected(self, ex):
        with pytest.raises(ValueError):
            ftt.plan(512, executor=ex)

    @pytest.mark.parametrize("n", [1, 512, 1000, 4093, 1 << 22])
    def test_auto_resolves_to_lax(self, n):
        assert Plan(n)._resolve_executor() == "lax"


def test_wisdom_roundtrip(tmp_path):
    p = str(tmp_path / "wisdom.json")
    key = ("gpu", 4096, 1024, -1)
    autotune.TUNE_CACHE[key] = "lax"
    autotune.OVERLAP_CACHE[("NVIDIA H100 80GB HBM3", 4)] = 2
    try:
        autotune.save_wisdom(p)
        autotune.TUNE_CACHE.clear()
        autotune.OVERLAP_CACHE.clear()
        autotune.load_wisdom(p)
        assert autotune.TUNE_CACHE[key] == "lax"
        assert autotune.OVERLAP_CACHE[("NVIDIA H100 80GB HBM3", 4)] == 2
    finally:
        autotune.TUNE_CACHE.pop(key, None)
        autotune.OVERLAP_CACHE.pop(("NVIDIA H100 80GB HBM3", 4), None)


def test_wisdom_toolchain_stamp_invalidates(tmp_path):
    # wisdom measured on another jax/jaxlib (or the legacy unstamped
    # format) must be discarded, not trusted
    p = str(tmp_path / "wisdom.json")
    key = ("gpu", 777, 8, -1)
    autotune.TUNE_CACHE[key] = "xla"
    try:
        autotune.save_wisdom(p)
    finally:
        del autotune.TUNE_CACHE[key]
    data = json.load(open(p))
    assert data["__toolchain__"] == autotune._toolchain_stamp()

    # stale stamp -> ignored
    data["__toolchain__"] = "jax=0.0.0;jaxlib=0.0.0"
    json.dump(data, open(p, "w"))
    autotune.load_wisdom(p)
    assert key not in autotune.TUNE_CACHE

    # legacy flat format (no stamp) -> ignored
    json.dump({"gpu|777|8|-1": "xla"}, open(p, "w"))
    autotune.load_wisdom(p)
    assert key not in autotune.TUNE_CACHE


def test_wisdom_lives_in_the_checkout():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(autotune._WISDOM_PATH) == repo
