"""Serving-deployment pattern: persistent compile cache + plan warmup.

First process start pays the kernel compiles; every later start loads them
from the on-disk cache and `Plan.warmup` makes the serving path hot before
traffic arrives.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fft_wgpu_tpu as ftt
from fft_wgpu_tpu.utils.io import enable_persistent_compilation_cache


def main():
    cache = enable_persistent_compilation_cache()
    print(f"compilation cache: {cache}")

    t0 = time.perf_counter()
    plan = ftt.plan(4096).warmup(batch_shape=(1024,))
    # also warm the host<->device transfer path with a tiny round trip
    z = np.zeros((1, 4096), np.complex64)
    _ = ftt.device_get_complex(plan.forward(z))
    print(f"warmup (compile or cache hit): {time.perf_counter()-t0:.1f}s")

    # serve "requests"
    rng = np.random.default_rng(0)
    for i in range(3):
        x = (rng.standard_normal((1024, 4096)) + 1j * rng.standard_normal((1024, 4096))).astype(np.complex64)
        t0 = time.perf_counter()
        y = plan.forward(x)
        yh = ftt.device_get_complex(y)
        print(f"request {i}: {time.perf_counter()-t0:.3f}s end-to-end "
              f"(incl. host transfers), |y|={np.linalg.norm(yh):.3e}")

    # AOT artifact: ship the lowered executors; the serving process
    # replays them with zero Python tracing (plan/aot.py)
    import tempfile

    art = os.path.join(tempfile.mkdtemp(), "fft4096.ftta")
    ftt.export_plan(plan, art, batch_shape=(1024,))
    print(f"exported {os.path.getsize(art)/1024:.0f} KiB artifact")
    sp = ftt.load_plan(art)
    re = np.random.default_rng(1).standard_normal((1024, 4096)).astype("float32")
    im = np.zeros_like(re)
    t0 = time.perf_counter()
    fr, fi = sp.forward_split(re, im)
    fr.block_until_ready()
    print(f"AOT replay: {time.perf_counter()-t0:.3f}s, {sp!r}")


if __name__ == "__main__":
    main()
