"""Plan-based FFT scheduler (the `processor.rs` equivalent).

The reference's public surface is plan-style objects constructed once per
(buffer, fft_len) and replayed cheaply (`Forward::new` / `proc`,
fft_wgpu src/processor.rs:7-159).  Here a :class:`Plan` is constructed once
per transform length; "replay" is calling its jitted executors — XLA caches
the compiled program, the analogue of the reference's cached
`ComputePipeline` (processor.rs:161-229).

Executors (``executor=`` of :class:`Plan`):
  * ``"auto"``    — resolves to ``"lax"`` on every platform
  * ``"lax"``     — XLA's own FFT (`jax.lax.fft`; cuFFT on the GPU), any n
  * ``"fourstep"``— Bailey decomposition n = n1*n2 into two batched sub-FFTs
  * ``"xla"``     — the jnp DFT-by-matmul mixed-radix recursion
                    (ops/stockham.py)
  * ``"direct"``  — one O(n^2) DFT matmul
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

from ..core.complex_utils import merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from ..ops import stockham

__all__ = ["Plan", "plan", "get_plan", "lax_fft", "EXECUTORS"]

EXECUTORS = ("auto", "lax", "xla", "fourstep", "direct")


def lax_fft(z, sign: int, scale=None, ndims: int = 1):
    """XLA's FFT of complex `z` over its last `ndims` (1-3) axes, times
    `scale`.  `sign` FORWARD is unscaled; INVERSE is unnormalized, as the
    split-domain executors are (lax's IFFT divides by the length, which is
    folded back into the one output multiply)."""
    lengths = tuple(z.shape[-ndims:])
    batch = z.shape[:-ndims]
    total = 1.0 if scale is None else float(scale)
    # one leading batch axis: XLA's CPU FFT requires a row-major operand,
    # and with several batch axes its layout assignment may permute them
    z = z.reshape((-1,) + lengths)
    if sign == FORWARD:
        z = lax.fft(z, lax.FftType.FFT, lengths)
    else:
        z = lax.fft(z, lax.FftType.IFFT, lengths)
        total *= math.prod(lengths)
    z = z.reshape(batch + lengths)
    if abs(total - 1.0) > 1e-12:
        z = z * jnp.float32(total)
    return z


class Plan:
    """FFT plan for 1-D transforms of length ``n`` along the last axis.

    API parity with the reference plan objects (SURVEY §2 C4-C11):
      forward                -> Forward::proc        (processor.rs:110-158)
      inverse                -> Inverse::proc        (processor.rs:293-340, fused 1/N)
      inverse_unnormalized   -> Onlyinverse::proc    (processor.rs:622-669)
      normalize              -> Normalize::proc      (processor.rs:467-504)
    """

    def __init__(self, n: int, *, executor: str = "auto", dtype=jnp.complex64,
                 donate: bool = False, autotune: bool = False):
        if n < 1:
            raise ValueError(f"fft length must be >= 1, got {n}")
        self.n = int(n)
        # The compute path is complex64 (split re/im float32 at the
        # boundary); other precisions are not silently accepted.
        if jnp.dtype(dtype) != jnp.dtype(jnp.complex64):
            raise ValueError(
                f"unsupported dtype {dtype!r}: plans compute in float32 and "
                "return complex64 (use dtype=jnp.complex64)"
            )
        self.dtype = jnp.complex64
        if executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {executor!r}; expected one of {EXECUTORS}")
        self.executor = executor
        # autotune=True (FFTW_MEASURE analogue): measure the executor
        # candidates on-device once per (n, batch-rows, axis) and use the
        # winner; executor="auto" otherwise (plan/autotune.py).
        self.autotune = bool(autotune)
        # donate=True donates the (re, im) input buffers to XLA so replaying
        # the plan allocates nothing new — the analogue of the reference's
        # caller-owned in-place ping-pong buffers
        # (fft_wgpu src/processor.rs:580-586, parity dance :153-157).
        # The caller's input arrays are INVALIDATED by each call.
        self.donate = bool(donate)
        # One compiled executable per (axis, sign, scale) — the analogue
        # of the reference's cached ComputePipeline (processor.rs:28,161-229).
        # jax.jit adds per-shape caching on top.
        self._jit_cache: dict = {}

    # ------------------------------------------------------------------ #
    # executor selection (trace-time; shapes are static under jit)
    # ------------------------------------------------------------------ #
    def _resolve_executor(self) -> str:
        return "lax" if self.executor == "auto" else self.executor

    # ------------------------------------------------------------------ #
    # split-domain executors (re/im pairs, transform along last axis)
    # ------------------------------------------------------------------ #
    def _execute_split(self, re, im, sign: int, scale, ex: str | None = None):
        if re.shape[-1] != self.n:
            raise ValueError(
                f"plan built for n={self.n}, input last axis is {re.shape[-1]}"
            )
        ex = ex or self._resolve_executor()
        if ex == "lax":
            z = lax_fft(lax.complex(re, im), sign, scale)
            return jnp.real(z), jnp.imag(z)
        if ex == "fourstep":
            from ..ops import fourstep

            return fourstep.fft_last_axis(re, im, sign, scale)
        if ex == "direct":
            re, im = stockham._dft_direct(re, im, sign)
            return stockham.apply_scale(re, im, scale)
        re, im = stockham.fft_last_axis(re, im, sign)
        return stockham.apply_scale(re, im, scale)

    def _execute_split_axis(self, re, im, sign: int, scale, axis: int,
                            ex: str | None = None):
        """Transform along `axis`: a non-minor axis moves to the back, is
        transformed there and moves back."""
        ax = axis % re.ndim
        if ax == re.ndim - 1:
            return self._execute_split(re, im, sign, scale, ex)
        re = jnp.moveaxis(re, ax, -1)
        im = jnp.moveaxis(im, ax, -1)
        re, im = self._execute_split(re, im, sign, scale, ex)
        return jnp.moveaxis(re, -1, ax), jnp.moveaxis(im, -1, ax)

    # ------------------------------------------------------------------ #
    # public complex-facade methods
    # ------------------------------------------------------------------ #
    def _tuned_for(self, shape, axis: int):
        """Measured executor for this shape (autotune=True, executor
        'auto'); None = executor 'auto' as it resolves."""
        if not self.autotune or self.executor != "auto":
            return None
        if shape[axis] != self.n:
            return None
        from . import autotune

        return autotune.measure_executor(self, tuple(shape), axis)

    def _jitted(self, axis: int, sign: int, scale, ex: str | None = None):
        """Cached jitted executor: (re, im) real arrays -> complex64.

        The whole transform — axis moves, all stages, scaling, and the
        complex merge — is one compiled program that takes planar float32
        and returns a device-resident complex64.
        """
        key = (axis, sign, scale, ex)
        fn = self._jit_cache.get(key)
        if fn is None:

            def impl(re, im):
                if (ex or self._resolve_executor()) == "lax":
                    z = jnp.moveaxis(lax.complex(re, im), axis, -1)
                    return jnp.moveaxis(lax_fft(z, sign, scale), -1, axis)
                return merge(*self._execute_split_axis(re, im, sign, scale,
                                                       axis, ex))

            if self.donate:
                fn = jax.jit(impl, donate_argnums=(0, 1))
            else:
                fn = jax.jit(impl)
            self._jit_cache[key] = fn
        return fn

    def _run(self, x, axis: int, sign: int, scale):
        re, im = promote_to_split(x)
        if re.shape[axis] != self.n:
            raise ValueError(
                f"plan built for n={self.n}, input axis {axis} has length "
                f"{re.shape[axis]}"
            )
        ex = self._tuned_for(re.shape, axis)
        return self._jitted(axis, sign, scale, ex)(re, im)

    def _jitted_split(self, axis: int, sign: int, scale,
                      ex: str | None = None):
        """Cached jitted executor in the SPLIT domain: (re, im) -> (re, im).

        This is the form where donate=True achieves true in-place replay —
        the f32 outputs alias the donated f32 inputs (the complex-facade
        methods cannot alias: their complex64 output has a different
        dtype, so XLA declines the donation with a warning)."""
        key = ("split", axis, sign, scale, ex)
        fn = self._jit_cache.get(key)
        if fn is None:

            def impl(re, im):
                return self._execute_split_axis(re, im, sign, scale, axis, ex)

            if self.donate:
                fn = jax.jit(impl, donate_argnums=(0, 1))
            else:
                fn = jax.jit(impl)
            self._jit_cache[key] = fn
        return fn

    def forward_split(self, re, im, axis: int = -1):
        """Forward FFT on a split (re, im) float32 pair -> split pair.

        The zero-copy serving form: with donate=True the outputs reuse the
        input buffers (the reference's caller-owned ping-pong buffers,
        processor.rs:580-586); the inputs are INVALIDATED."""
        ex = self._tuned_for(jnp.shape(re), axis)
        return self._jitted_split(axis, FORWARD, None, ex)(re, im)

    def inverse_split(self, re, im, axis: int = -1):
        """Inverse FFT with fused 1/N on a split pair -> split pair."""
        ex = self._tuned_for(jnp.shape(re), axis)
        return self._jitted_split(axis, INVERSE, 1.0 / self.n, ex)(re, im)

    def inverse_unnormalized_split(self, re, im, axis: int = -1):
        """Unnormalized inverse on a split pair -> split pair."""
        ex = self._tuned_for(jnp.shape(re), axis)
        return self._jitted_split(axis, INVERSE, None, ex)(re, im)

    def forward(self, x, axis: int = -1):
        """Forward FFT, unscaled (reference Forward, processor.rs:7-159)."""
        return self._run(x, axis, FORWARD, None)

    def inverse(self, x, axis: int = -1):
        """Inverse FFT with fused 1/N (reference Inverse — the 1/N division
        is fused into the last butterfly stage, ifft.wgsl:65-74; here it is
        folded into the executor epilogue)."""
        return self._run(x, axis, INVERSE, 1.0 / self.n)

    def inverse_unnormalized(self, x, axis: int = -1):
        """Inverse FFT without the 1/N scale (reference Onlyinverse,
        processor.rs:566-670)."""
        return self._run(x, axis, INVERSE, None)

    def normalize(self, x, axis: int = -1):
        """Standalone 1/N scaling pass (reference Normalize,
        processor.rs:409-505; normalize.wgsl:10-11)."""
        del axis  # elementwise — axis kept for API symmetry
        re, im = promote_to_split(x)
        fn = self._jit_cache.get("normalize")
        if fn is None:
            s = 1.0 / self.n

            def impl(re, im):
                return merge(re * jnp.float32(s), im * jnp.float32(s))

            fn = jax.jit(impl)
            self._jit_cache["normalize"] = fn
        return fn(re, im)

    def warmup(self, batch_shape=(), axis: int = -1):
        """Ahead-of-time compile every executor for a given batch shape —
        the serving-path analogue of the reference's plan construction
        doing all pipeline compilation up front (processor.rs:19-108).
        Returns self for chaining."""
        shape = tuple(batch_shape) + (self.n,)
        for sign, scale in (
            (FORWARD, None),
            (INVERSE, 1.0 / self.n),
            (INVERSE, None),
        ):
            # fresh buffers per call: donate=True plans invalidate their
            # inputs on backends that honor donation, and the two donated
            # args must not alias each other
            re = jnp.zeros(shape, jnp.float32)
            im = jnp.zeros(shape, jnp.float32)
            jax.block_until_ready(self._jitted(axis, sign, scale)(re, im))
            # the split-domain executors are the zero-copy serving form —
            # warm them too (they are distinct compiled programs)
            re = jnp.zeros(shape, jnp.float32)
            im = jnp.zeros(shape, jnp.float32)
            jax.block_until_ready(
                self._jitted_split(axis, sign, scale)(re, im))
        return self

    def __repr__(self):
        return f"Plan(n={self.n}, executor={self.executor!r})"


def plan(n: int, **kw) -> Plan:
    """Construct an FFT plan (`Forward::new` analogue, processor.rs:19-108)."""
    return Plan(n, **kw)


@functools.lru_cache(maxsize=512)
def get_plan(n: int, executor: str = "auto") -> Plan:
    """Module-level plan cache used by the functional API (fft/ifft/...)."""
    return Plan(n, executor=executor)
