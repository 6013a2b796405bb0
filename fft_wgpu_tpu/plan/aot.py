"""Ahead-of-time plan artifacts for serving (jax.export).

The reference compiles its pipelines at plan construction and replays
them forever (fft_wgpu src/processor.rs:19-108); the analogue of
*shipping* that work is a serialized StableHLO artifact: every
executor of a plan, traced and lowered for fixed serving shapes, written
to one portable file.  A serving process loads the artifact and replays
the transforms with ZERO Python tracing — combined with the persistent
XLA compilation cache (`utils/io.enable_persistent_compilation_cache`)
the first call after load skips straight to execution.

    p = ftt.plan(4096)
    ftt.export_plan(p, "fft4096.ftta", batch_shape=(512,))

    sp = ftt.load_plan("fft4096.ftta")          # no Plan, no tracing
    re, im = sp.forward_split(re, im)

Artifacts are self-describing zip containers: a `meta.json` (n, shapes,
axis, ops, jax version, lowering platforms) plus one serialized
`jax.export.Exported` per op.  Executors run in the SPLIT (re, im)
domain — the zero-copy serving form (complex never crosses the host
boundary, framework invariant).
"""

from __future__ import annotations

import io
import json
import zipfile

import jax
import jax.numpy as jnp

from ..core.twiddle import FORWARD, INVERSE

__all__ = ["export_plan", "load_plan", "AOTPlan"]

_FORMAT = "fft_wgpu_tpu-aot-v1"
_OPS = ("forward", "inverse", "inverse_unnormalized")


def _op_sign_scale(n: int, op: str):
    return {
        "forward": (FORWARD, None),
        "inverse": (INVERSE, 1.0 / n),
        "inverse_unnormalized": (INVERSE, None),
    }[op]


def export_plan(p, path=None, *, batch_shape=(), axis: int = -1,
                ops=_OPS, platforms=None):
    """Serialize plan `p`'s executors for `batch_shape + (n,)` inputs.

    `path=None` returns the artifact as bytes; otherwise writes the file
    and returns `path`.  `platforms` optionally cross-lowers for other
    backends (e.g. ("cuda",) from a CPU host), default: current backend.
    """
    from jax import export as jexport

    shape = tuple(int(b) for b in batch_shape) + (p.n,)
    spec = jax.ShapeDtypeStruct(shape, jnp.float32)
    meta = {
        "format": _FORMAT,
        "n": p.n,
        "shape": list(shape),
        "axis": int(axis),
        "ops": list(ops),
        "jax_version": jax.__version__,
        "platforms": list(platforms) if platforms else
                     [jax.default_backend()],
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for op in ops:
            if op not in _OPS:
                raise ValueError(f"unknown op {op!r}; expected {_OPS}")
            sign, scale = _op_sign_scale(p.n, op)

            def impl(re, im, _sign=sign, _scale=scale):
                return p._execute_split_axis(re, im, _sign, _scale, axis)

            exp = jexport.export(
                jax.jit(impl),
                platforms=meta["platforms"],
            )(spec, spec)
            z.writestr(f"{op}.jaxexp", bytes(exp.serialize()))
        z.writestr("meta.json", json.dumps(meta, indent=1))
    data = buf.getvalue()
    if path is None:
        return data
    with open(path, "wb") as f:
        f.write(data)
    return path


class AOTPlan:
    """A loaded serving artifact: split-domain executors only, fixed
    shapes, no tracing.  Mirrors the Plan split API (`forward_split`,
    `inverse_split`, `inverse_unnormalized_split`)."""

    def __init__(self, meta: dict, exported: dict):
        self.n = int(meta["n"])
        self.shape = tuple(meta["shape"])
        self.axis = int(meta["axis"])
        self.platforms = tuple(meta["platforms"])
        self._meta = meta
        self._calls = {
            op: jax.jit(exp.call) for op, exp in exported.items()
        }

    def _run(self, op, re, im):
        fn = self._calls.get(op)
        if fn is None:
            raise ValueError(
                f"artifact was exported without {op!r} "
                f"(has {sorted(self._calls)})")
        if jnp.shape(re) != self.shape:
            raise ValueError(
                f"artifact serves shape {self.shape}, got {jnp.shape(re)}")
        return fn(re, im)

    def forward_split(self, re, im):
        return self._run("forward", re, im)

    def inverse_split(self, re, im):
        return self._run("inverse", re, im)

    def inverse_unnormalized_split(self, re, im):
        return self._run("inverse_unnormalized", re, im)

    def __repr__(self):
        return (f"AOTPlan(n={self.n}, shape={self.shape}, "
                f"platforms={self.platforms})")


def load_plan(src) -> AOTPlan:
    """Load a serving artifact from a path or bytes -> :class:`AOTPlan`."""
    from jax import export as jexport

    data = src if isinstance(src, (bytes, bytearray)) \
        else open(src, "rb").read()
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != _FORMAT:
            raise ValueError(f"not a {_FORMAT} artifact")
        exported = {
            op: jexport.deserialize(bytearray(z.read(f"{op}.jaxexp")))
            for op in meta["ops"]
        }
    return AOTPlan(meta, exported)
