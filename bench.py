#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line for the driver.

Headline metric (BASELINE.json): batched 1-D fp32 C2C FFT GFLOP/s
(5 N log2 N convention) at N=4096 x batch 4096 through the plan layer's
"auto" route, against the device-memory roofline of the card it runs on
(utils/roofline.py, published peaks keyed by device kind; an unknown kind
is an error).  vs_baseline is achieved/(0.8 * roofline).

Device times come from a `jax.profiler` trace of the card
(utils/profiling.device_times): the median busy time over 20 synced
calls.  Inputs are generated on the device and only scalar validation
metrics cross back to the host.

Extra (non-headline) rows are printed to stderr for the record; the
headline JSON is printed first and again as the final stdout line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time

if __name__ == "__main__" and "--headline-child" not in sys.argv:
    # The parent never imports jax, so the measuring child is the only
    # process on the card (a JAX process reserves most of its memory).
    jax = jnp = np = None
else:
    import jax
    import jax.numpy as jnp
    import numpy as np

_METRIC = "batched 1D C2C FFT N=4096 batch=4096 fp32 GFLOP/s (5NlogN)"


def _device_time(fn, args):
    """Median device busy time (s) of `fn(*args)` from a profiler trace."""
    from fft_wgpu_tpu.utils.profiling import device_times

    return statistics.median(device_times(fn, args))


def _rel(got, want):
    """On-device rel-L2 of split pairs, one scalar transfer."""
    (gr, gi), (wr, wi) = got, want
    return float(jnp.sqrt(jnp.sum((gr - wr) ** 2 + (gi - wi) ** 2)
                          / jnp.sum(wr ** 2 + wi ** 2)))


def _stock(x):
    X = jnp.fft.fft(x, axis=-1)
    return jnp.real(X), jnp.imag(X)


def bench_batched_1d(n=4096, batch=4096, executor="auto"):
    """Forward batched 1-D C2C; returns (seconds, roundtrip_rel_l2,
    impulse_max_err)."""
    from fft_wgpu_tpu.plan.plan import get_plan

    p = get_plan(n, executor)
    re = jax.random.normal(jax.random.PRNGKey(0), (batch, n), jnp.float32)
    im = jax.random.normal(jax.random.PRNGKey(1), (batch, n), jnp.float32)
    fwd = jax.jit(lambda a, b: p._execute_split(a, b, -1, None))
    inv = jax.jit(lambda a, b: p._execute_split(a, b, +1, 1.0 / n))
    dt = _device_time(fwd, (re, im))

    rt = _rel(inv(*fwd(re, im)), (re, im))
    d = jnp.zeros((8, n), jnp.float32).at[:, 0].set(1.0)
    dr, di = fwd(d, jnp.zeros_like(d))
    imp = float(jnp.max(jnp.abs(dr - 1.0)) + jnp.max(jnp.abs(di)))
    return dt, rt, imp


def _copy_floor(n, batch):
    """Device time of a plain elementwise pass that reads and writes the
    same bytes as the transform (two f32 planes in, two out)."""
    re = jax.random.normal(jax.random.PRNGKey(20), (batch, n), jnp.float32)
    im = jax.random.normal(jax.random.PRNGKey(21), (batch, n), jnp.float32)
    return _device_time(jax.jit(lambda a, b: (a + 1.0, b + 1.0)), (re, im))


def main():
    """Parent: run the measurement in a killable child process and forward
    its output; print a failure line if the child hangs or dies."""
    import queue
    import signal
    import subprocess
    import threading

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--headline-child"],
        stdout=subprocess.PIPE,
        text=True,
        start_new_session=True,  # killpg reaches any grandchildren
    )
    lines: queue.Queue = queue.Queue()

    def _pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=_pump, daemon=True).start()

    def _kill():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    try:
        headline = lines.get(
            timeout=float(os.environ.get("BENCH_HEADLINE_TIMEOUT", "1500")))
    except queue.Empty:
        headline = None
    if headline is None:
        _kill()
        # failure JSON is the only (and therefore final) stdout line
        print(json.dumps({
            "metric": _METRIC,
            "value": 0.0,
            "unit": "GFLOP/s",
            "vs_baseline": 0.0,
            "error": "measurement child hung or died before producing "
                     "the headline",
        }), flush=True)
        return
    print(headline, end="", flush=True)

    # secondary rows stream on the child's stderr (inherited); bound the
    # remainder so a stuck row cannot hold the driver forever
    deadline = time.monotonic() + 2700
    while True:
        try:
            item = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            print("# secondary rows timed out; killing child",
                  file=sys.stderr, flush=True)
            _kill()
            break
        if item is None:
            break
        print(item, end="", flush=True)
    proc.wait()

    # the driver parses the FINAL stdout line: re-print the headline
    print(headline, end="" if headline.endswith("\n") else "\n", flush=True)


def child_main():
    import fft_wgpu_tpu as ftt
    from fft_wgpu_tpu.utils.io import enable_persistent_compilation_cache
    from fft_wgpu_tpu.utils.roofline import hbm_bandwidth, roofline

    enable_persistent_compilation_cache()
    dev = jax.devices()[0]
    n, batch = 4096, 4096
    dt, rt_err, imp_err = bench_batched_1d(n, batch)
    r = roofline(n, batch, dt, passes=1, device=dev)
    copy_s = _copy_floor(n, batch)

    result = {
        "metric": f"{_METRIC} on {dev.device_kind}",
        "value": r["gflops"],
        "unit": "GFLOP/s",
        "vs_baseline": r["fraction"] / 0.8,
        "roofline_fraction": r["fraction"],
        "roofline_gflops": r["roofline_gflops"],
        "ms": dt * 1e3,
        "copy_floor_ms": copy_s * 1e3,
        "copy_floor_fraction_of_hbm": (4.0 * batch * n * 4
                                       / hbm_bandwidth(dev) / copy_s),
        "roundtrip_rel_l2": f"{rt_err:.2e}",
        "impulse_max_err": f"{imp_err:.2e}",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
    }
    print(json.dumps(result), flush=True)

    def _row(tag, thunk):
        try:
            print(f"# {tag}: {thunk()}", file=sys.stderr, flush=True)
        except Exception as e:
            print(f"# {tag}: failed: {e}", file=sys.stderr, flush=True)

    def _c2c(n2, b2, executor="auto"):
        p = ftt.plan(n2, executor=executor)
        re = jax.random.normal(jax.random.PRNGKey(2), (b2, n2), jnp.float32)
        im = jax.random.normal(jax.random.PRNGKey(3), (b2, n2), jnp.float32)
        fn = jax.jit(lambda a, b: p._execute_split(a, b, -1, None))
        stock = jax.jit(lambda a, b: _stock(jax.lax.complex(a, b)))
        err = _rel(fn(re, im), stock(re, im))
        dt2 = _device_time(fn, (re, im))
        ts = _device_time(stock, (re, im))
        gf = 5.0 * n2 * math.log2(n2) * b2 / dt2 / 1e9
        return (f"{dt2 * 1e3:.4f} ms, {gf:.1f} GFLOP/s, vs_stock="
                f"{ts / dt2:.3f}x, rel_vs_stock={err:.2e}")

    def _fft2(n2):
        x = jax.random.normal(jax.random.PRNGKey(4), (n2, n2), jnp.float32)
        z = jax.lax.complex(x, x[::-1])
        fn = jax.jit(lambda v: ftt.fft2(v))
        dt2 = _device_time(fn, (z,))
        return f"{dt2 * 1e3:.4f} ms"

    def _r2c(n2, b2):
        x = jax.random.normal(jax.random.PRNGKey(5), (b2, n2), jnp.float32)
        fn = jax.jit(lambda v: ftt.rfft(v))
        dt2 = _device_time(fn, (x,))
        return f"{dt2 * 1e3:.4f} ms"

    def _end_to_end(n2, b2, iters=20):
        """The reference's own loop (examples/basic.rs): host numpy in,
        transform, host numpy out, timed on the host clock."""
        p = ftt.plan(n2)
        x = (np.random.default_rng(0).standard_normal((b2, n2))
             + 1j * np.random.default_rng(1).standard_normal((b2, n2))
             ).astype(np.complex64)
        ftt.device_get_complex(p.forward(x))
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            ftt.device_get_complex(p.forward(x))
            ts.append(time.perf_counter() - t0)
        return f"{statistics.median(ts) * 1e3:.4f} ms host-clock median"

    _row("reference shape 2500x512", lambda: _c2c(512, 2500))
    _row("N=2^22 x1", lambda: _c2c(1 << 22, 1))
    _row("prime n=4093 x 1024", lambda: _c2c(4093, 1024))
    _row("composite n=4095 x 1024", lambda: _c2c(4095, 1024))
    _row("matmul recursion 4096x4096 (executor xla)",
         lambda: _c2c(4096, 4096, "xla"))
    _row("2-D 4096x4096 C2C", lambda: _fft2(4096))
    _row("R2C 4096 x 4096 rows", lambda: _r2c(4096, 4096))
    _row("end-to-end 2500x512 (reference loop)", lambda: _end_to_end(512, 2500))


if __name__ == "__main__":
    if "--headline-child" in sys.argv:
        child_main()
    else:
        main()
