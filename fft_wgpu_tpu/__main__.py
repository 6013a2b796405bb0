"""Command-line entry: ``python -m fft_wgpu_tpu <cmd>``.

The reference's binary entry (fft_wgpu src/main.rs:1-6) runs one hard-
coded demo; this exposes the framework's operational surface instead:

    info         device/backend/roofline summary (one JSON line)
    selftest     quick oracle check of the core paths on this backend
    export-plan  serialize a plan's executors to an AOT artifact
    bench        full benchmark harness (delegates to bench.py)
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_info(args) -> int:
    import jax

    import fft_wgpu_tpu as ftt
    from fft_wgpu_tpu.utils.roofline import hbm_bandwidth

    dev = jax.devices()[0]
    try:  # published peak; null for a kind without one (e.g. the CPU)
        bw = round(hbm_bandwidth(dev) / 1e9, 1)
    except ValueError:
        bw = None
    info = {
        "version": ftt.__version__,
        "backend": jax.default_backend(),
        "device_kind": getattr(dev, "device_kind", str(dev)),
        "device_count": jax.device_count(),
        "hbm_bandwidth_GBps": bw,
    }
    print(json.dumps(info))
    return 0


def _cmd_selftest(args) -> int:
    import numpy as np

    import fft_wgpu_tpu as ftt

    rng = np.random.default_rng(0)
    ok = True

    def check(tag, got, want, tol=1e-5):
        nonlocal ok
        rel = float(np.linalg.norm(np.asarray(got) - want)
                    / np.linalg.norm(want))
        good = rel < tol
        ok &= good
        print(f"  {tag}: rel={rel:.2e} {'ok' if good else 'FAIL'}")

    n = args.n
    x = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
         ).astype(np.complex64)
    p = ftt.plan(n)
    check("plan.forward", ftt.device_get_complex(p.forward(x)),
          np.fft.fft(x, axis=-1))
    check("plan roundtrip",
          ftt.device_get_complex(p.inverse(p.forward(x))), x)
    xr = rng.standard_normal((8, n)).astype(np.float32)
    check("rfft", ftt.device_get_complex(ftt.rfft(xr)),
          np.fft.rfft(xr, axis=-1))
    check("dct-II", np.asarray(ftt.dct(xr)),
          __import__("scipy.fft", fromlist=["dct"]).dct(xr), tol=1e-4)
    import scipy.signal as sig  # scipy is already required above

    sperseg = min(512, n)
    sx = rng.standard_normal(16 * sperseg).astype(np.float32)
    f1, p1 = ftt.welch(sx, nperseg=sperseg)
    f2, p2 = sig.welch(sx, nperseg=sperseg)
    check("welch", np.asarray(p1), p2, tol=1e-4)
    print("selftest:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _cmd_export_plan(args) -> int:
    import fft_wgpu_tpu as ftt

    p = ftt.plan(args.n)
    ftt.export_plan(p, args.out, batch_shape=(args.batch,))
    print(f"exported plan(n={args.n}, batch={args.batch}) -> {args.out}")
    return 0


def _cmd_bench(args) -> int:
    import os
    import subprocess

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "bench.py")
    if not os.path.exists(path):
        print("bench.py not found (the benchmark harness ships with the "
              "repo checkout, not the installed package)", file=sys.stderr)
        return 2
    return subprocess.run([sys.executable, path]).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fft_wgpu_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info", help="device/backend summary (JSON)")
    st = sub.add_parser("selftest", help="quick oracle check")
    st.add_argument("--n", type=int, default=1024)
    ep = sub.add_parser("export-plan", help="AOT plan artifact")
    ep.add_argument("n", type=int)
    ep.add_argument("out")
    ep.add_argument("--batch", type=int, default=8)
    sub.add_parser("bench", help="full benchmark harness")
    args = ap.parse_args(argv)
    return {"info": _cmd_info, "selftest": _cmd_selftest,
            "export-plan": _cmd_export_plan, "bench": _cmd_bench,
            }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
