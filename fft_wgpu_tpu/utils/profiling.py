"""Tracing / profiling hooks (SURVEY §5: absent in the reference, which
only has wall-clock `Instant` + `dbg!` — fft_wgpu examples/basic.rs:70,129).

Provides:
* `trace(dir)` — context manager around `jax.profiler` so any transform
  call can be captured for xprof/tensorboard.
* `op_stats(n, batch, seconds)` — per-op GFLOP/s (5 N log2 N convention)
  and HBM roofline fraction, the structured counterpart of the reference's
  printed elapsed times.
* `annotate(name)` — named trace region for plan executors.
* `device_times(fn, args)` — per-call device time of a jitted function,
  read from a `jax.profiler` trace of the device (the reduction the
  benchmark and chip_smoke.py share).
"""

from __future__ import annotations

import contextlib
import glob
import math
import re
import tempfile
import time

import jax

from .roofline import fft_flops, hbm_bandwidth

__all__ = ["trace", "annotate", "op_stats", "trace_calls", "device_times",
           "busy_ns", "split_calls"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profile of the enclosed block (view with xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named profiler region (shows up in the trace timeline)."""
    return jax.profiler.TraceAnnotation(name)


def op_stats(n: int, batch: int, seconds: float, *, passes: int = 1,
             device=None) -> dict:
    """GFLOP/s + roofline accounting for one batched-1D FFT execution."""
    bw = hbm_bandwidth(device)
    flops = fft_flops(n, batch)
    bytes_moved = 2.0 * batch * n * 8.0 * passes
    return {
        "n": n,
        "batch": batch,
        "seconds": seconds,
        "gflops": flops / seconds / 1e9,
        "gbps": bytes_moved / seconds / 1e9,
        "roofline_fraction": (bytes_moved / bw) / seconds,
        "flops_per_element": 5.0 * math.log2(n),
    }


# trace lines that summarise kernels (modules, ops, steps) rather than
# being the kernels themselves; counting them would double-count
_SUMMARY_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source", "TraceMe",
                  "Framework")


def busy_ns(events) -> float:
    """Length of the union of (start_ns, end_ns) intervals: the time in
    which at least one of `events` runs."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def split_calls(events, calls: int):
    """Split kernel events (tuples ending in start_ns, end_ns) of `calls`
    calls that were separated by idle gaps into one list per call, at the
    calls-1 widest gaps between consecutive events."""
    events = sorted(events, key=lambda e: e[-2])
    if len(events) < calls:
        raise RuntimeError(
            f"{len(events)} device events for {calls} calls")
    gaps, end = [], events[0][-1]
    for i in range(1, len(events)):
        gaps.append((events[i][-2] - end, i))
        end = max(end, events[i][-1])
    cuts = sorted(i for _, i in sorted(gaps)[len(gaps) - (calls - 1):]) \
        if calls > 1 else []
    out, prev = [], 0
    for c in cuts + [len(events)]:
        out.append(events[prev:c])
        prev = c
    return out


def trace_calls(fn, args, calls: int = 20):
    """Kernel events of each of `calls` synced calls of `fn(*args)`, from
    a profiler trace of the device planes: one list per call of
    (device_plane, kernel_name, start_ns, end_ns).

    Each call is synced and followed by an idle gap, so the trace's
    kernel events split into calls at the widest gaps.  Raises
    RuntimeError when the trace has no device plane (e.g. on the CPU
    backend): there is no host-clock fallback.
    """
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))  # compile + warm outside the window
    with tempfile.TemporaryDirectory(prefix="ffttrace") as tmp:
        with jax.profiler.trace(tmp):
            for _ in range(calls):
                jax.block_until_ready(fn(*args))
                time.sleep(2e-3)
        paths = glob.glob(f"{tmp}/**/*.xplane.pb", recursive=True)
        if not paths:
            raise RuntimeError("profiler wrote no trace")
        pd = ProfileData.from_file(paths[0])
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if any(k in line.name for k in _SUMMARY_LINES):
                continue
            events += [(plane.name, e.name, e.start_ns,
                        e.start_ns + e.duration_ns) for e in line.events]
    if not events:
        raise RuntimeError("the trace holds no device kernel events")
    return split_calls(events, calls)


def device_times(fn, args, calls: int = 20, match: str | None = None):
    """Device busy time in seconds of each of `calls` synced calls of
    `fn(*args)` (see trace_calls).  `match` (a case-insensitive regular
    expression) keeps only the kernels whose name matches it."""
    pat = re.compile(match, re.I) if match else None
    return [busy_ns([(s, e) for _, name, s, e in call
                     if pat is None or pat.search(name)]) / 1e9
            for call in trace_calls(fn, args, calls)]
