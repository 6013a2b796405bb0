"""Measured executor selection — the FFTW_MEASURE analogue for plans.

The reference constructs its plan objects with a fixed kernel strategy
per entry point (fft_wgpu src/processor.rs:19-108); FFTW-style planners
instead MEASURE candidate schedules and keep the winner.  `plan(n,
autotune=True)` does that here: each (n, batch-rows, axis) is timed once
per process across the executor candidates valid for the shape, and the
fastest becomes the plan's executor for matching calls.

Timing: a device-side `fori_loop` chain executed at two different
lengths, scalar readback, and the per-iteration cost taken from the
SLOPE, so per-call dispatch latency cancels.  Candidates compile once
each; with the persistent compilation cache enabled this is cheap on
re-runs.  Decisions persist in a wisdom file inside the checkout.
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp

__all__ = ["candidates_for", "measure_executor", "TUNE_CACHE",
           "OVERLAP_CACHE", "load_wisdom", "save_wisdom",
           "tune_overlap_chunks", "default_overlap_chunks"]

# (backend, n, rows_bucket, axis) -> executor name
TUNE_CACHE: dict = {}

# (device_kind, ndev) -> FFT->a2a pipeline chunk count for the
# distributed transforms (tune_overlap_chunks measures it per mesh)
OVERLAP_CACHE: dict = {}

_WISDOM_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".fft_wisdom.json")
_wisdom_loaded = False


def _bucket(rows: int) -> int:
    """Row-count regime bucket: the executor ranking is assumed stable
    within these (few rows, a moderate batch, a large batch)."""
    if rows < 16:
        return 8
    if rows < 128:
        return 64
    return 1024


def _toolchain_stamp() -> str:
    """Version stamp for the wisdom file: rankings measured on one
    jax/jaxlib do not survive upgrades that change lowering — a mismatch
    would silently keep stale rankings."""
    import jax

    import jaxlib

    return f"jax={jax.__version__};jaxlib={jaxlib.__version__}"


def load_wisdom(path: str = _WISDOM_PATH) -> None:
    """Load persisted tuning decisions (FFTW-wisdom analogue).  Called
    lazily by measure_executor; safe to call again after clearing.
    Files stamped with a different jax/jaxlib version (or the legacy
    unstamped format) are ignored — stale pins are worse than
    re-measuring."""
    global _wisdom_loaded
    _wisdom_loaded = True
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("__toolchain__") != _toolchain_stamp():
            return  # stale or legacy-format wisdom: discard
        data = data.get("entries", {})
        for k, v in data.items():
            parts = k.split("|")
            if parts[0] == "overlap":
                _, kind, ndev = parts
                OVERLAP_CACHE[(kind, int(ndev))] = int(v)
            else:
                backend, n, rows_b, axis = parts
                TUNE_CACHE[(backend, int(n), int(rows_b), int(axis))] = v
    except (OSError, ValueError):
        pass


def save_wisdom(path: str = _WISDOM_PATH) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = {"|".join(map(str, k)): v for k, v in TUNE_CACHE.items()}
        for (kind, ndev), c in OVERLAP_CACHE.items():
            data[f"overlap|{kind}|{ndev}"] = c
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"__toolchain__": _toolchain_stamp(),
                       "entries": data}, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass


def candidates_for(n: int, rows: int) -> list[str]:
    """Executor candidates worth measuring for this shape: XLA's FFT and
    the matmul recursion always; four-step where n splits."""
    from ..ops.fourstep import choose_factors

    cands = ["lax", "xla"]
    if choose_factors(n)[0] > 1:
        cands.append("fourstep")
    return cands


def _slope_time(fn_split, shape, repeats=2) -> float:
    """Per-iteration device time of `fn_split(re, im) -> (re, im)` via a
    two-length chained fori_loop — dispatch latency cancels in the slope.  Chain lengths scale up adaptively
    until the slope window is well above dispatch jitter, so small
    workloads don't mis-rank."""
    re = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)
    im = jax.random.normal(jax.random.PRNGKey(1), shape, jnp.float32)

    @jax.jit
    def run(a, b, k):
        def body(_, c):
            return tuple(fn_split(c[0], c[1]))

        a, b = jax.lax.fori_loop(0, k, body, (a, b))
        return jnp.sum(a[..., 0]) + jnp.sum(b[..., 0])

    _ = float(run(re, im, 1))  # compile + warm
    lo, hi = 4, 20
    for _attempt in range(4):
        best = float("inf")
        window = 0.0
        for _ in range(repeats):
            t0 = time.perf_counter()
            _ = float(run(re, im, lo))
            t1 = time.perf_counter()
            _ = float(run(re, im, hi))
            t2 = time.perf_counter()
            window = max(window, (t2 - t1) - (t1 - t0))
            best = min(best, ((t2 - t1) - (t1 - t0)) / (hi - lo))
        if window >= 0.04 or hi >= 2048:  # >=40 ms of signal in the slope
            return best
        lo, hi = lo * 4, hi * 4
    return best


def measure_executor(plan, shape, axis: int) -> str:
    """Pick the fastest executor for `plan.n` at this batch shape, caching
    per (backend, n, rows-bucket, axis) with on-disk wisdom persistence."""
    backend = jax.default_backend()
    rows = 1
    for d in shape[:-1]:
        rows *= int(d)
    rb = 1 if rows == 1 else _bucket(rows)
    key = (backend, plan.n, rb, axis)
    if not _wisdom_loaded:
        load_wisdom()
    hit = TUNE_CACHE.get(key)
    if hit is not None:
        return hit
    cands = candidates_for(plan.n, rows)
    if len(cands) == 1:
        TUNE_CACHE[key] = cands[0]
        return cands[0]
    from ..core.twiddle import FORWARD

    best_ex, best_t = cands[0], float("inf")
    for ex in cands:
        fn = lambda a, b, _ex=ex: plan._execute_split_axis(
            a, b, FORWARD, None, axis, ex=_ex)
        try:
            t = _slope_time(fn, tuple(shape))
        except Exception:
            continue  # candidate does not compile/run for this shape
        if t < best_t:
            best_ex, best_t = ex, t
    TUNE_CACHE[key] = best_ex
    save_wisdom()
    return best_ex


# --------------------------------------------------------------------- #
# FFT->all-to-all pipeline depth (overlap_chunks) tuning
# --------------------------------------------------------------------- #

def default_overlap_chunks(mesh) -> int:
    """Pipeline chunk count for a distributed FFT on `mesh`: the measured
    pin for (device kind, mesh size) when tune_overlap_chunks has run (or
    prior wisdom exists), else 4 on real meshes / 1 on a single device
    (nothing to hide without an interconnect)."""
    if mesh is None or mesh.devices.size <= 1:
        return 1
    if not _wisdom_loaded:
        load_wisdom()
    kind = mesh.devices.flat[0].device_kind
    return OVERLAP_CACHE.get((kind, int(mesh.devices.size)), 4)


def tune_overlap_chunks(mesh, shape=(256, 256, 256),
                        candidates=(1, 2, 4, 8), repeats=3, *,
                        persist: bool = True) -> int:
    """Measure fft3d wall time per pipeline depth on THIS mesh and pin
    the winner for (device kind, mesh size).

    Timing uses a device-side scalar reduction read back per run (full
    execution forced without a complex D2H).  On a real multi-card mesh
    this measures true interconnect/compute overlap; on the virtual CPU mesh it
    measures the chunking overhead floor (still the right default when
    no hardware measurement exists — see tests/test_distributed.py for
    the structural overlap proof).
    """
    from ..parallel import pencil

    kind = mesh.devices.flat[0].device_kind
    ndev = int(mesh.devices.size)
    key = (kind, ndev)
    if not _wisdom_loaded:
        load_wisdom()

    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jax.device_put(
        jnp.zeros(shape, jnp.float32),
        NamedSharding(mesh, P(*mesh.axis_names, None)))
    best_c, best_t = candidates[0], float("inf")
    for c in candidates:
        fn = jax.jit(lambda v, _c=c: jnp.sum(jnp.real(
            pencil.fft3d(v, mesh=mesh, overlap_chunks=_c))))
        try:
            _ = float(fn(x))  # compile + warm
            t = min(_timed_scalar(fn, x) for _ in range(repeats))
        except Exception:
            continue
        if t < best_t:
            best_c, best_t = c, t
    OVERLAP_CACHE[key] = best_c
    if persist:
        save_wisdom()
    return best_c


def _timed_scalar(fn, x) -> float:
    t0 = time.perf_counter()
    _ = float(fn(x))
    return time.perf_counter() - t0
