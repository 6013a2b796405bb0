#!/usr/bin/env python
"""On-card smoke test of the FFT library's main path on an NVIDIA GPU.

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --cards 4   # four cards: the pencil 3-D phase only

Drives the public entry points (`plan(n).forward/inverse/...`, `fft`,
`fft2`, `rfft`/`irfft`, `czt`, `fftconvolve`, `SpectralFilter`,
`parallel.pencil`) at the reference's deployment sizes (BASELINE.json
configs 1-5), with inputs made from `--seed`, and checks each result
against numpy in float64 (or `naive_dft`) by relative L2 error.  Device
times come from a `jax.profiler` trace of the card.  Any failure raises
before the last line; on success the last stdout line is one JSON object
naming the device.  Exits non-zero, printing no result, when JAX finds no
GPU or when the library is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
GEMM = r"gemm|xmma|cutlass|cublas|dot"
COLLECTIVE = r"nccl|all-to-all|alltoall|all_to_all|sendrecv|p2p"


def _rel(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm((got - want).ravel())
                 / np.linalg.norm(want.ravel()))


def _check(tag, got, want, tol=TOL) -> float:
    rel = _rel(got, want)
    print(f"  {tag}: rel_l2={rel:.3e} tol={tol:.0e}", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{tag}: rel_l2 {rel:.3e} > {tol:.0e}")
    return rel


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# --------------------------------------------------------------------- #
# one-card phases
# --------------------------------------------------------------------- #

def phase_config1(ftt, rng, n=1024):
    x = _cplx(rng, (n,))
    _check(f"fft n={n} vs naive_dft", ftt.device_get_complex(ftt.fft(x)),
           ftt.naive_dft(x.astype(np.complex128)))


def phase_config2(ftt, rng, n=4096, batch=4096):
    x = _cplx(rng, (batch, n))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    p = ftt.plan(n)
    X = p.forward(x)
    _check("plan.forward", ftt.device_get_complex(X), want)
    _check("ftt.fft", ftt.device_get_complex(ftt.fft(x)), want)
    _check("plan.inverse(forward)", ftt.device_get_complex(p.inverse(X)), x)
    back = p.normalize(p.inverse_unnormalized(X))
    _check("plan.normalize(inverse_unnormalized(forward))",
           ftt.device_get_complex(back), x)
    re = np.ascontiguousarray(x.real)
    compiled = p._jitted(-1, -1, None).lower(re, re).compile()
    print(f"  memory_analysis: {compiled.memory_analysis()}", flush=True)


def phase_served(ftt, rng, n=512, batch=2500, requests=8):
    """The reference's loop (examples/basic.rs): host numpy in, host numpy
    out, through one plan."""
    p = ftt.plan(n)
    worst, times = 0.0, []
    for _ in range(requests):
        x = _cplx(rng, (batch, n))
        t0 = time.perf_counter()
        got = ftt.device_get_complex(p.forward(x))
        times.append(time.perf_counter() - t0)
        worst = max(worst, _rel(got, np.fft.fft(x.astype(np.complex128),
                                                 axis=-1)))
    print(f"  {requests} requests {batch}x{n}: host-clock median "
          f"{statistics.median(times) * 1e3:.3f} ms (first includes "
          f"compilation)", flush=True)
    if not worst <= TOL:
        raise AssertionError(f"served: rel_l2 {worst:.3e} > {TOL:.0e}")
    print(f"  served: worst rel_l2={worst:.3e} tol={TOL:.0e}", flush=True)


def phase_config3(ftt, rng, n=1 << 22):
    x = _cplx(rng, (n,))
    _check(f"fft n=2^{n.bit_length() - 1}",
           ftt.device_get_complex(ftt.fft(x)),
           np.fft.fft(x.astype(np.complex128)))


def phase_config4(ftt, rng, n=4096):
    x = _cplx(rng, (n, n))
    _check("fft2", ftt.device_get_complex(ftt.fft2(x)),
           np.fft.fft2(x.astype(np.complex128)))
    r = rng.standard_normal((n, n)).astype(np.float32)
    R = ftt.rfft(r)
    want = np.fft.rfft(r.astype(np.float64), axis=-1)
    _check("rfft", ftt.device_get_complex(R), want)
    _check("irfft(rfft)", np.asarray(ftt.irfft(R, n=n)), r)


def phase_any_length(ftt, rng, batch=256):
    import scipy.signal as sig

    for n in (4093, 4095, 3 << 11):
        x = _cplx(rng, (batch, n))
        _check(f"fft n={n}", ftt.device_get_complex(ftt.fft(x)),
               np.fft.fft(x.astype(np.complex128), axis=-1))
    x = _cplx(rng, (16, 1000))
    w = np.exp(-2j * np.pi * 0.3 / 500)
    a = np.exp(2j * np.pi * 0.05)
    _check("czt m=500", ftt.device_get_complex(ftt.czt(x, m=500, w=w, a=a)),
           sig.czt(x.astype(np.complex128), m=500, w=w, a=a))
    # linear convolution served by the SpectralFilter path: both operands
    # zero-padded to the full length L, circular == linear there
    sgl = rng.standard_normal((64, 4000)).astype(np.float32)
    h = rng.standard_normal(97).astype(np.float32)
    want = sig.fftconvolve(sgl.astype(np.float64), h[None].astype(np.float64))
    L = sgl.shape[-1] + h.size - 1
    filt = ftt.SpectralFilter(np.pad(h, (0, L - h.size)), domain="time")
    got = filt(np.pad(sgl, ((0, 0), (0, L - sgl.shape[-1]))))
    _check("SpectralFilter linear convolution",
           np.real(ftt.device_get_complex(got)), want)
    _check("fftconvolve", np.asarray(ftt.fftconvolve(sgl, h[None])), want)


def phase_gradient(ftt, rng, n=4096, batch=64):
    import jax
    import jax.numpy as jnp

    x = _cplx(rng, (batch, n))
    w = _cplx(rng, (batch, n))

    def loss(xr, xi):
        X = ftt.fft(jax.lax.complex(xr, xi))
        return jnp.sum(jnp.abs(X * jnp.asarray(w)) ** 2)

    gr, gi = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(x.real), jnp.asarray(x.imag))
    x64 = x.astype(np.complex128)
    # d/dx of sum |w . F x|^2 = 2 F^H (|w|^2 . F x),  F^H = n * ifft
    want = 2.0 * n * np.fft.ifft(np.abs(w) ** 2 * np.fft.fft(x64, axis=-1),
                                 axis=-1)
    _check("grad sum|fft(x).w|^2 vs analytic adjoint",
           np.asarray(gr) + 1j * np.asarray(gi), want)

    from fft_wgpu_tpu.utils.precision import TOLERANCE

    ref = np.fft.fft(x64, axis=-1)
    _check("recursion (executor xla) accurate",
           ftt.device_get_complex(ftt.plan(n, executor="xla").forward(x)),
           ref, TOLERANCE["accurate"])
    with ftt.dot_precision("fast"):
        got = ftt.device_get_complex(
            ftt.plan(n, executor="xla").forward(x))
        _check("recursion (executor xla) fast (TF32 bound)", got, ref,
               TOLERANCE["fast"])


def phase_timing(ftt, card, n=4096, batch=4096, calls=20):
    """The timing triple at n x batch C2C, device time from the trace."""
    import jax
    import jax.numpy as jnp

    from fft_wgpu_tpu.utils.profiling import trace_calls, busy_ns

    def med(fn, args, match=None, names=False):
        import re as _re

        per_call = trace_calls(fn, args, calls)
        pat = _re.compile(match, _re.I) if match else None
        ts = [busy_ns([(s, e) for _, nm, s, e in c
                       if pat is None or pat.search(nm)]) / 1e9
              for c in per_call]
        if names:
            tot: dict = {}
            for _, nm, s, e in per_call[len(per_call) // 2]:
                tot[nm] = tot.get(nm, 0) + (e - s)
            top = sorted(tot.items(), key=lambda kv: -kv[1])[:6]
            print("    kernels: " + "; ".join(
                f"{k[:60]} {v / 1e3:.1f}us" for k, v in top), flush=True)
        return statistics.median(ts)

    key = jax.random.PRNGKey(7)
    re = jax.random.normal(key, (batch, n), jnp.float32)
    im = jax.random.normal(jax.random.fold_in(key, 1), (batch, n),
                           jnp.float32)
    z = jax.jit(jax.lax.complex)(re, im)
    p = ftt.plan(n)
    split_fn = jax.jit(lambda a, b: p._execute_split(a, b, -1, None))
    rows = {}
    rows["a0 lax.fft complex64 alone"] = med(
        jax.jit(lambda v: jax.lax.fft(v, jax.lax.FftType.FFT, (n,))), (z,))
    rows["a1 plan.forward (complex in, complex out)"] = med(p.forward, (z,))
    rows["a2 lax route, split-domain executor"] = med(split_fn, (re, im))
    rec = ftt.plan(n, executor="xla")
    rows["b matmul recursion at HIGHEST"] = med(
        jax.jit(lambda a, b: rec._execute_split(a, b, -1, None)), (re, im),
        names=True)
    with ftt.dot_precision("fast"):
        rec = ftt.plan(n, executor="xla")
        rows["c recursion GEMM kernels only at DEFAULT (TF32)"] = med(
            jax.jit(lambda a, b: rec._execute_split(a, b, -1, None)),
            (re, im), match=GEMM, names=True)
    for k, v in rows.items():
        print(f"  {k}: {v * 1e3:.4f} ms (median of {calls} calls, {card})",
              flush=True)
    a, c = rows["a2 lax route, split-domain executor"], \
        rows["c recursion GEMM kernels only at DEFAULT (TF32)"]
    verdict = ("(a) beats (c): no DFT-by-matmul kernel port" if a < c
               else "(c) beats (a): a matmul kernel is the first perf_opt "
                    "candidate")
    print(f"  verdict: {verdict}", flush=True)


# --------------------------------------------------------------------- #
# four-card phase
# --------------------------------------------------------------------- #

def _shard_check(tag, y, ref0, dev0, tol=TOL):
    """rel-L2 of sharded `y` against `ref0` (whole, on dev0): each shard
    goes to dev0 once and is compared with its slice there."""
    import jax
    import jax.numpy as jnp

    num = den = 0.0
    diff = jax.jit(lambda a, b: (jnp.sum(jnp.abs(a - b) ** 2),
                                 jnp.sum(jnp.abs(b) ** 2)))
    for sh in y.addressable_shards:
        d, r = diff(jax.device_put(sh.data, dev0), ref0[sh.index])
        num += float(d)
        den += float(r)
    rel = (num / den) ** 0.5
    print(f"  {tag}: rel_l2={rel:.3e} tol={tol:.0e}", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{tag}: rel_l2 {rel:.3e} > {tol:.0e}")


def _assert_spread(tag, arr, ndev):
    """The array is split over all ndev cards, none holding it whole."""
    shards = arr.addressable_shards
    devs = {sh.device for sh in shards}
    if len(devs) != ndev or any(sh.data.size * ndev != arr.size
                                for sh in shards):
        raise AssertionError(
            f"{tag}: not split evenly over {ndev} cards: "
            f"{[(str(sh.device), sh.data.shape) for sh in shards]}")


def pencil_phase(n=1024, ndev=4, card=None, calls=5):
    """fft3d/ifft3d and rfft3d of an n^3 cube over a 2x2 pencil mesh,
    each against lax.fft 3-D of the whole cube on card 0."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fft_wgpu_tpu.parallel.mesh import make_pencil_mesh
    from fft_wgpu_tpu.parallel.pencil import fft3d, ifft3d, rfft3d

    devs = jax.devices()[:ndev]
    if len(devs) != ndev:
        raise RuntimeError(f"need {ndev} devices, JAX has {len(devs)}")
    mesh = make_pencil_mesh(devs)
    print(f"  mesh {dict(mesh.shape)} over {ndev} devices", flush=True)
    spec = NamedSharding(mesh, P(*mesh.axis_names, None))
    seed = jax.random.PRNGKey(11)
    gen = jax.jit(lambda k: jax.lax.complex(
        jax.random.normal(k, (n, n, n), jnp.float32),
        jax.random.normal(jax.random.fold_in(k, 1), (n, n, n), jnp.float32)),
        out_shardings=spec)
    x = gen(seed)
    _assert_spread("input", x, ndev)
    dev0 = devs[0]
    lengths = (n, n, n)
    lfft = jax.jit(lambda v, t: jax.lax.fft(v, t, lengths),
                   static_argnums=1)

    f3 = jax.jit(lambda v: fft3d(v, mesh))  # one program: traced below
    y = f3(x)
    _assert_spread("fft3d output", y, ndev)
    x0 = jax.device_put(x, dev0)
    ref = lfft(x0, jax.lax.FftType.FFT)
    _shard_check("fft3d vs lax.fft 3-D on card 0", y, ref, dev0)
    del ref, y
    yi = ifft3d(x, mesh)
    _assert_spread("ifft3d output", yi, ndev)
    ref = lfft(x0, jax.lax.FftType.IFFT)
    _shard_check("ifft3d vs lax.fft 3-D on card 0", yi, ref, dev0)
    del ref, yi, x0
    r = jax.jit(jnp.real, out_shardings=spec)(x)
    yr = rfft3d(r, mesh)
    _assert_spread("rfft3d output", yr, ndev)
    ref = lfft(jax.device_put(r, dev0), jax.lax.FftType.RFFT)
    _shard_check("rfft3d vs lax.fft 3-D on card 0", yr, ref, dev0)
    del ref, yr

    if card is None:  # CPU rehearsal: no device trace to read
        return
    import re as _re

    from fft_wgpu_tpu.utils.profiling import busy_ns, trace_calls

    pat = _re.compile(COLLECTIVE, _re.I)
    per_call = trace_calls(f3, (x,), calls)
    exposed, coll, total = [], [], []
    for call in per_call:
        for plane in sorted({e[0] for e in call}):
            ev = [e for e in call if e[0] == plane]
            comp = [(s, e) for _, nm, s, e in ev if not pat.search(nm)]
            allk = [(s, e) for _, _, s, e in ev]
            coll.append(busy_ns([(s, e) for _, nm, s, e in ev
                                 if pat.search(nm)]))
            exposed.append(busy_ns(allk) - busy_ns(comp))
            total.append(busy_ns(allk))
    names = sorted({nm[:50] for _, nm, _, _ in per_call[0]
                    if pat.search(nm)})
    tot: dict = {}
    for _, nm, s, e in per_call[-1]:
        tot[nm[:50]] = tot.get(nm[:50], 0) + (e - s)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:6]
    print("    kernels (all cards, one call): " + "; ".join(
        f"{k} {v / 1e3:.1f}us" for k, v in top), flush=True)
    print(f"  fft3d {n}^3 per card per call (median over {calls} calls x "
          f"{ndev} cards, {card}): busy {statistics.median(total) / 1e6:.3f}"
          f" ms, all-to-all {statistics.median(coll) / 1e6:.3f} ms, exposed"
          f" all-to-all {statistics.median(exposed) / 1e6:.3f} ms; "
          f"collective kernels: {names[:4]}", flush=True)


# --------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import fft_wgpu_tpu as ftt

    pkg = os.path.dirname(os.path.abspath(ftt.__file__))
    if pkg != os.path.join(HERE, "fft_wgpu_tpu"):
        print(f"fft_wgpu_tpu imported from {pkg}, not beside this script",
              file=sys.stderr)
        return 2
    import jax

    from fft_wgpu_tpu.utils.io import enable_persistent_compilation_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        return 1
    if len(devs) < args.cards:
        print(f"--cards {args.cards} but JAX found {len(devs)} GPUs",
              file=sys.stderr)
        return 1
    enable_persistent_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    card = smi[0]
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)

    rng = np.random.default_rng(args.seed)
    if args.cards == 4:
        phases = [("pencil 3-D 1024^3 on 4 cards",
                   lambda: pencil_phase(1024, 4, card))]
    else:
        phases = [
            ("1 config 1: n=1024", lambda: phase_config1(ftt, rng)),
            ("2 config 2: 4096x4096 C2C", lambda: phase_config2(ftt, rng)),
            ("3 served path 2500x512", lambda: phase_served(ftt, rng)),
            ("4 config 3: n=2^22", lambda: phase_config3(ftt, rng)),
            ("5 config 4: fft2 / rfft / irfft 4096x4096",
             lambda: phase_config4(ftt, rng)),
            ("6 any length, czt, convolution",
             lambda: phase_any_length(ftt, rng)),
            ("7 gradient and precision", lambda: phase_gradient(ftt, rng)),
            ("8 timing triple 4096x4096", lambda: phase_timing(ftt, card)),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        print(f"phase {name}", flush=True)
        run()
        print(f"  done in {time.perf_counter() - t0:.1f} s (host clock, "
              f"compilation included)", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
