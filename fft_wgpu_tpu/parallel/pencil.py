"""Distributed FFTs: slab / pencil decomposition over a device mesh.

New subsystem vs the single-device reference (SURVEY §2/§5): multi-chip
transforms are expressed with `shard_map` over a `jax.sharding.Mesh`, with
`jax.lax.all_to_all` corner turns that XLA hands to NCCL over NVLink — the
transpose steps of distributed GPU FFT stacks.

Decompositions
--------------
* ``fft3d`` — pencil: [X, Y, Z] on a 2-D mesh (X/px, Y/py pencils along Z).
  Z-FFT local → a2a(py): Z<->Y → Y-FFT → a2a(px): Y<->X → X-FFT.
  ``transposed_output=True`` (default False) skips the two a2a's that
  restore the input distribution, the standard HPC trick (P3DFFT-style).
* ``fft2d`` — slab: [X, Y] on a 1-D mesh.
* ``fft1d_distributed`` — a single huge vector via the distributed
  four-step: factor-sharded sub-FFTs with one a2a corner turn; the
  inter-factor twiddle is computed per-shard from `axis_index`.

All compute runs on split re/im pairs inside shard_map; each local
sub-transform goes through the plan layer's "auto" route (XLA's FFT).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.complex_utils import merge, promote_to_split
from ..core.twiddle import FORWARD, INVERSE
from .mesh import make_mesh, make_pencil_mesh

try:  # jax >= 0.6 moved shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["fft3d", "ifft3d", "fft2d", "ifft2d", "fft1d_distributed", "rfft3d", "irfft3d"]


def _fft_axis_local(re, im, axis, sign, scale):
    """Local (per-shard) FFT along `axis` through the plan layer."""
    from ..plan.plan import get_plan

    moved = axis not in (-1, re.ndim - 1)
    if moved:
        re = jnp.moveaxis(re, axis, -1)
        im = jnp.moveaxis(im, axis, -1)
    p = get_plan(re.shape[-1], "auto")
    re, im = p._execute_split(re, im, sign, scale)
    if moved:
        re = jnp.moveaxis(re, -1, axis)
        im = jnp.moveaxis(im, -1, axis)
    return re, im


def _norm_comm_dtype(comm_dtype):
    """Validate the corner-turn wire dtype (None = full f32)."""
    if comm_dtype is None:
        return None
    dt = jnp.dtype(comm_dtype)
    if dt not in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float32)):
        raise ValueError(
            f"comm_dtype must be None, float32 or bfloat16, got {comm_dtype}")
    return None if dt == jnp.dtype(jnp.float32) else dt


def _a2a(pair, axis_name, split_axis, concat_axis, comm_dtype=None):
    re, im = pair
    if comm_dtype is not None:
        # mixed-precision corner turn: halve the wire bytes of the
        # collective.  The cast costs one elementwise pass each way; rel
        # error ~bf16 eps (4e-3) per turn on the intermediate spectrum —
        # opt-in only.
        re = re.astype(comm_dtype)
        im = im.astype(comm_dtype)
    re = jax.lax.all_to_all(re, axis_name, split_axis, concat_axis, tiled=True)
    im = jax.lax.all_to_all(im, axis_name, split_axis, concat_axis, tiled=True)
    if comm_dtype is not None:
        re = re.astype(jnp.float32)
        im = im.astype(jnp.float32)
    return re, im


def _fft_then_a2a_chunked(re, im, fft_axis, sign, scale, axis_name,
                          split_axis, concat_axis, chunk_axis, chunks,
                          comm_dtype=None):
    """FFT along `fft_axis` then all-to-all, pipelined in `chunks` slices
    along `chunk_axis` (an axis participating in neither the FFT nor the
    a2a).  Chunk i's a2a depends only on chunk i's FFT, so XLA's async
    collectives (start/done pairs) overlap chunk i's transfer with chunk
    i+1's compute — the SURVEY §7 hard part ("pencil 3-D FFT must overlap
    the all-to-all with per-pencil compute").  chunks=1 is
    the unpipelined baseline."""
    if chunks <= 1 or re.shape[chunk_axis] < chunks:
        re, im = _fft_axis_local(re, im, fft_axis, sign, scale)
        return _a2a((re, im), axis_name, split_axis, concat_axis, comm_dtype)
    assert chunk_axis not in (split_axis, concat_axis)
    n = re.shape[chunk_axis]
    step = -(-n // chunks)
    outs_r, outs_i = [], []
    for s in range(0, n, step):
        sl = [slice(None)] * re.ndim
        sl[chunk_axis] = slice(s, min(s + step, n))
        cr, ci = re[tuple(sl)], im[tuple(sl)]
        cr, ci = _fft_axis_local(cr, ci, fft_axis, sign, scale)
        cr, ci = _a2a((cr, ci), axis_name, split_axis, concat_axis,
                      comm_dtype)
        outs_r.append(cr)
        outs_i.append(ci)
    return (jnp.concatenate(outs_r, chunk_axis),
            jnp.concatenate(outs_i, chunk_axis))


# --------------------------------------------------------------------- #
# 3-D pencil FFT
# --------------------------------------------------------------------- #
def _fft3d_impl(x, mesh, sign, scale, transposed_output, overlap_chunks=None,
                comm_dtype=None, transposed_input=False):
    ax, ay = mesh.axis_names
    comm_dtype = _norm_comm_dtype(comm_dtype)
    if transposed_input and transposed_output:
        raise ValueError("transposed_input and transposed_output are "
                         "mutually exclusive")
    if overlap_chunks is None:
        # measured pin for (device kind, mesh size) when available, else
        # 4 on real meshes / 1 single-device (plan/autotune wisdom)
        from ..plan.autotune import default_overlap_chunks
        overlap_chunks = default_overlap_chunks(mesh)
    lead = len(jnp.shape(x)) - 3  # leading batch dims (replicated)
    if lead < 0:
        raise ValueError("fft3d expects at least 3 dimensions")

    def local(re, im):
        # in: [.., X/px, Y/py, Z].  Each FFT->a2a pair is chunk-pipelined
        # along a spectator axis so the transfer of one chunk overlaps
        # the next chunk's pencil FFTs (see _fft_then_a2a_chunked).
        o = re.ndim - 3
        re, im = _fft_then_a2a_chunked(                          # Z-FFT
            re, im, o + 2, sign, None, ay, o + 2, o + 1, o,
            overlap_chunks, comm_dtype)                          # -> [.., X/px, Y, Z/py]
        re, im = _fft_then_a2a_chunked(                          # Y-FFT
            re, im, o + 1, sign, None, ax, o + 1, o, o + 2,
            overlap_chunks, comm_dtype)                          # -> [.., X, Y/px, Z/py]
        re, im = _fft_axis_local(re, im, o, sign, scale)         # X-FFT
        if not transposed_output:
            re, im = _a2a((re, im), ax, o, o + 1, comm_dtype)    # -> [.., X/px, Y, Z/py]
            re, im = _a2a((re, im), ay, o + 1, o + 2, comm_dtype)  # -> [.., X/px, Y/py, Z]
        return re, im

    def local_t(re, im):
        # transposed-input mirror schedule: in [.., X, Y/px, Z/py] (the
        # exact layout transposed_output leaves behind) -> natural out.
        # Each FFT->a2a pair pipelines along the spectator axis.
        o = re.ndim - 3
        re, im = _fft_then_a2a_chunked(                          # X-FFT
            re, im, o, sign, None, ax, o, o + 1, o + 2,
            overlap_chunks, comm_dtype)                          # -> [.., X/px, Y, Z/py]
        re, im = _fft_then_a2a_chunked(                          # Y-FFT
            re, im, o + 1, sign, None, ay, o + 1, o + 2, o,
            overlap_chunks, comm_dtype)                          # -> [.., X/px, Y/py, Z]
        re, im = _fft_axis_local(re, im, o + 2, sign, scale)     # Z-FFT
        return re, im

    b = (None,) * lead
    natural = P(*b, ax, ay, None)
    transposed = P(*b, None, ax, ay)
    in_spec = transposed if transposed_input else natural
    out_spec = transposed if transposed_output else natural
    re, im = promote_to_split(x)

    fn = shard_map(
        local_t if transposed_input else local,
        mesh=mesh,
        in_specs=(in_spec, in_spec),
        out_specs=(out_spec, out_spec),
    )
    re, im = jax.jit(fn)(re, im)
    return merge(re, im)


def fft3d(x, mesh: Mesh | None = None, norm=None, *, transposed_output=False,
          overlap_chunks: int | None = None, comm_dtype=None,
          transposed_input=False):
    """Distributed 3-D forward FFT over the LAST three axes, pencil-
    decomposed over a 2-D mesh (leading axes are replicated batch dims).

    `overlap_chunks` pipelines each FFT->all-to-all pair in that many
    chunks so the transfers overlap pencil compute (default: 4 on real
    meshes, 1 single-device).

    `comm_dtype=jnp.bfloat16` sends the all-to-all corner turns over the
    wire in bf16 (compute stays f32), halving the bytes of the corner
    turns.  Opt-in: each bf16 turn
    rounds the intermediate spectrum to ~3 decimal digits (measured
    ~1e-3 rel L2 end to end); default None keeps full f32 wires.

    `transposed_output=True` returns the natural logical array in the
    TRANSPOSED distribution (X unsharded, Y/px, Z/py), skipping the two
    restoring corner turns (2 instead of 4 — P3DFFT-style); feed it back
    through `ifft3d(..., transposed_input=True)` to complete a 4-turn
    (instead of 8-turn) filter round trip."""
    mesh = mesh or make_pencil_mesh()
    scale = _nd_scale(jnp.shape(x)[-3:], norm, FORWARD)
    return _fft3d_impl(x, mesh, FORWARD, scale, transposed_output,
                       overlap_chunks, comm_dtype, transposed_input)


def ifft3d(x, mesh: Mesh | None = None, norm=None, *, transposed_output=False,
           overlap_chunks: int | None = None, comm_dtype=None,
           transposed_input=False):
    """Distributed 3-D inverse FFT (1/N total scale folded into the last
    axis pass, mirroring the reference's fused normalize — ifft.wgsl:65-74).
    `comm_dtype` as in fft3d (bf16 wire turns, opt-in); `transposed_input`
    consumes a `transposed_output` spectrum via the mirror schedule
    (X-FFT -> turn -> Y-FFT -> turn -> Z-FFT), so the round trip pays 4
    corner turns total instead of 8."""
    mesh = mesh or make_pencil_mesh()
    scale = _nd_scale(jnp.shape(x)[-3:], norm, INVERSE)
    return _fft3d_impl(x, mesh, INVERSE, scale, transposed_output,
                       overlap_chunks, comm_dtype, transposed_input)


def _nd_scale(shape, norm, sign):
    total = math.prod(shape)  # the transformed axes only
    if norm in (None, "backward"):
        return None if sign == FORWARD else 1.0 / total
    if norm == "ortho":
        return total**-0.5
    if norm == "forward":
        return 1.0 / total if sign == FORWARD else None
    raise ValueError(f"invalid norm {norm!r}")


# --------------------------------------------------------------------- #
# 2-D slab FFT
# --------------------------------------------------------------------- #
def _fft2d_impl(x, mesh, sign, scale, comm_dtype=None):
    (ax,) = mesh.axis_names
    comm = _norm_comm_dtype(comm_dtype)
    lead = len(jnp.shape(x)) - 2  # leading batch dims (replicated)
    if lead < 0:
        raise ValueError("fft2d expects at least 2 dimensions")

    def local(re, im):
        # in: [.., X/p, Y]
        o = re.ndim - 2
        re, im = _fft_axis_local(re, im, o + 1, sign, None)  # Y-FFT
        re, im = _a2a((re, im), ax, o + 1, o, comm)          # -> [.., X, Y/p]
        re, im = _fft_axis_local(re, im, o, sign, scale)     # X-FFT
        re, im = _a2a((re, im), ax, o, o + 1, comm)          # -> [.., X/p, Y]
        return re, im

    spec = P(*(None,) * lead, ax, None)
    re, im = promote_to_split(x)
    fn = shard_map(
        local, mesh=mesh, in_specs=(spec,) * 2, out_specs=(spec,) * 2
    )
    re, im = jax.jit(fn)(re, im)
    return merge(re, im)


def fft2d(x, mesh: Mesh | None = None, norm=None, *, comm_dtype=None):
    """Distributed 2-D forward FFT over the LAST two axes, slab-decomposed
    over a 1-D mesh (leading axes are replicated batch dims).
    `comm_dtype=bfloat16` sends the corner turns in bf16 (see fft3d)."""
    mesh = mesh or make_mesh()
    return _fft2d_impl(x, mesh, FORWARD,
                       _nd_scale(jnp.shape(x)[-2:], norm, FORWARD),
                       comm_dtype)


def ifft2d(x, mesh: Mesh | None = None, norm=None, *, comm_dtype=None):
    """Distributed 2-D inverse FFT (slab)."""
    mesh = mesh or make_mesh()
    return _fft2d_impl(x, mesh, INVERSE,
                       _nd_scale(jnp.shape(x)[-2:], norm, INVERSE),
                       comm_dtype)


# --------------------------------------------------------------------- #
# Distributed 1-D FFT (single huge vector, four-step across the mesh)
# --------------------------------------------------------------------- #
def _divisible_factors(n: int, p: int) -> tuple[int, int] | None:
    """Most-balanced n = n1 * n2 with p | n1 and p | n2, or None."""
    if p <= 0 or n % (p * p):
        return None
    m = n // (p * p)
    best = None
    d = 1
    while d * d <= m:
        if m % d == 0:
            best = d  # largest divisor <= sqrt(m)
        d += 1
    if best is None:
        return None
    return p * best, p * (m // best)



def fft1d_distributed(x, mesh: Mesh | None = None, *, inverse=False,
                       norm=None, comm_dtype=None):
    """1-D FFT of a vector sharded across a 1-D mesh.

    The distributed analogue of ops/fourstep.py: view x[n] as A[n1, n2] with
    n1 sharded; the corner turn between the factor FFTs is one all-to-all.
    This is the framework's "sequence parallelism" (SURVEY §5: scaling
    transform length beyond one device).  `comm_dtype=bfloat16` sends the
    corner turns in bf16 (see fft3d).
    """
    mesh = mesh or make_mesh()
    comm = _norm_comm_dtype(comm_dtype)
    (axn,) = mesh.axis_names
    ndev = mesh.devices.size
    n = int(np.prod(jnp.shape(x)))
    sign = INVERSE if inverse else FORWARD

    from ..ops.fourstep import choose_factors

    if norm in (None, "backward"):
        scale = 1.0 / n if inverse else None
    elif norm == "ortho":
        scale = n**-0.5
    elif norm == "forward":
        scale = None if inverse else 1.0 / n
    else:
        raise ValueError(f"invalid norm {norm!r}")

    n1, n2 = choose_factors(n)
    if n1 % ndev or n2 % ndev:
        # Re-plan: find a factor pair with both factors divisible by the
        # mesh size; if none exists (n too small / wrong factors for this
        # mesh), fall back to a replicated single-shard transform instead
        # of erroring — every valid n stays computable on every mesh.
        pair = _divisible_factors(n, ndev)
        if pair is None:
            from ..plan.plan import get_plan

            re, im = promote_to_split(x)
            re = re.reshape(n)
            im = im.reshape(n)
            p = get_plan(n, "auto")
            rr, ii = jax.jit(
                lambda a, b: p._execute_split(a, b, sign, scale)
            )(re, im)
            return merge(rr, ii)
        n1, n2 = pair

    # Inter-factor twiddle plane, f64-generated on host in the transposed
    # [m2, k1] layout and *sharded over m2* by shard_map's in_specs — each
    # shard automatically receives exactly its slice (no axis_index math,
    # and no f32 phase blow-up at n ~ 2^22).
    from ..core.twiddle import twiddle_np

    twr_g, twi_g = twiddle_np(n1, n2, sign, transposed=True)

    def local(re, im, twr, twi):
        # in: [n1/p, n2] rows of A; twr/twi: [n2/p, n1]
        from ..plan.plan import get_plan

        # FFT over n1 requires n1 contiguous: corner turn first.
        re, im = _a2a((re, im), axn, 1, 0, comm)  # -> [n1, n2/p]
        p1 = get_plan(n1, "auto")
        rT, iT = jnp.swapaxes(re, 0, 1), jnp.swapaxes(im, 0, 1)  # [n2/p, n1]
        rT, iT = p1._execute_split(rT, iT, sign, None)           # B^T rows

        cr = rT * twr - iT * twi
        ci = rT * twi + iT * twr

        # corner turn so n2 is contiguous: [n2/p, n1] -> [n2, n1/p]
        cr, ci = _a2a((cr, ci), axn, 1, 0, comm)
        p2 = get_plan(n2, "auto")
        dr, di = jnp.swapaxes(cr, 0, 1), jnp.swapaxes(ci, 0, 1)  # [n1/p, n2]
        dr, di = p2._execute_split(dr, di, sign, scale)          # D[k1, k2]

        # natural order: X[k1 + n1 k2] == flatten of D^T; return D^T rows
        # [n2/p, n1] so the flattened global output is contiguous in k.
        dr, di = _a2a((dr, di), axn, 1, 0, comm)                 # [n1, n2/p]
        dr, di = jnp.swapaxes(dr, 0, 1), jnp.swapaxes(di, 0, 1)  # [n2/p, n1]
        return dr.reshape(-1), di.reshape(-1)

    re, im = promote_to_split(x)
    re = re.reshape(n1, n2)
    im = im.reshape(n1, n2)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axn, None),) * 4,
        out_specs=(P(axn),) * 2,
    )
    rr, ii = jax.jit(fn)(re, im, jnp.asarray(twr_g), jnp.asarray(twi_g))
    return merge(rr, ii)


# --------------------------------------------------------------------- #
# 3-D R2C / C2R pencil transforms (real simulation data)
# --------------------------------------------------------------------- #
def rfft3d(x, mesh: Mesh | None = None, norm=None, *,
           overlap_chunks: int | None = None, comm_dtype=None,
           transposed_output=False):
    """Distributed 3-D R2C: rfft over Z locally, then complex pencil FFTs
    over Y and X. Input real [X, Y, Z] sharded (px, py, -); output complex
    [X, Y, Z//2+1] with the same (px, py, -) distribution.
    `overlap_chunks` pipelines the Y/X FFT->a2a pairs and `comm_dtype`
    selects the corner-turn wire dtype (bf16 opt-in), both as in fft3d.

    `transposed_output=True` returns the natural logical spectrum in the
    transposed distribution (X unsharded, Y/px, Kz/py), skipping the two
    restoring corner turns — pair with `irfft3d(transposed_input=True)`
    for a 4-turn (instead of 8-turn) R2C round trip; the ns3d DNS stepper
    runs this way."""
    mesh = mesh or make_pencil_mesh()
    ax, ay = mesh.axis_names
    comm = _norm_comm_dtype(comm_dtype)
    shape = jnp.shape(x)
    if len(shape) < 3:
        raise ValueError("rfft3d expects at least 3 dimensions")
    X, Y, Z = shape[-3:]
    lead = len(shape) - 3
    scale = _nd_scale((X, Y, Z), norm, FORWARD)
    from ..plan.autotune import default_overlap_chunks
    chunks = default_overlap_chunks(mesh) \
        if overlap_chunks is None else overlap_chunks

    def local(xr):
        from ..ops.rfft import rfft_last_split

        o = xr.ndim - 3
        re, im = rfft_last_split(xr, None)                # [.., Xl, Yl, Z/2+1]
        # pad the half-spectrum axis to a multiple of the mesh for a2a
        nb = re.shape[-1]
        pad = (-nb) % mesh.devices.shape[1]
        if pad:
            pads = [(0, 0)] * (re.ndim - 1) + [(0, pad)]
            re = jnp.pad(re, pads)
            im = jnp.pad(im, pads)
        re, im = _a2a((re, im), ay, o + 2, o + 1, comm)   # [.., Xl, Y, Kz/py]
        re, im = _fft_then_a2a_chunked(                   # Y-FFT (pipelined)
            re, im, o + 1, FORWARD, None, ax, o + 1, o, o + 2, chunks, comm)
        re, im = _fft_axis_local(re, im, o, FORWARD, scale)
        if not transposed_output:
            re, im = _a2a((re, im), ax, o, o + 1, comm)   # [.., X/px, Y, Kz/py]
            re, im = _a2a((re, im), ay, o + 1, o + 2, comm)  # [.., X/px, Y/py, Kz]
        return re, im

    in_spec = P(*(None,) * lead, ax, ay, None)
    out_spec = P(*(None,) * lead, None, ax, ay) if transposed_output \
        else in_spec
    xr = jnp.asarray(x, jnp.float32)
    fn = shard_map(local, mesh=mesh, in_specs=(in_spec,),
                   out_specs=(out_spec, out_spec))
    re, im = jax.jit(fn)(xr)
    nb = Z // 2 + 1
    # the trailing pad rows are zeros; the slice only truncates the last
    # shard(s), so it moves no data between devices in either layout
    return merge(re[..., :nb], im[..., :nb])


def irfft3d(X, n_last: int, mesh: Mesh | None = None, norm=None, *,
            overlap_chunks: int | None = None, comm_dtype=None,
            transposed_input=False):
    """Distributed 3-D C2R inverse of :func:`rfft3d`.

    `n_last` is the real length of the Z axis (numpy irfft `n`);
    `overlap_chunks` pipelines the Y-pass FFT->a2a and `comm_dtype` the
    corner-turn wire dtype (bf16 opt-in), as in rfft3d.
    `transposed_input=True` consumes an `rfft3d(transposed_output=True)`
    spectrum via the mirror schedule (X-iFFT -> turn -> Y-iFFT -> turn ->
    C2R), halving the round trip's corner turns."""
    mesh = mesh or make_pencil_mesh()
    comm = _norm_comm_dtype(comm_dtype)
    from ..plan.autotune import default_overlap_chunks
    chunks = default_overlap_chunks(mesh) \
        if overlap_chunks is None else overlap_chunks
    ax, ay = mesh.axis_names
    re, im = promote_to_split(X)
    if re.ndim < 3:
        raise ValueError("irfft3d expects at least 3 dimensions")
    Xn, Yn, nb = re.shape[-3:]
    lead = re.ndim - 3
    total = Xn * Yn * n_last
    # The C2R step always contributes 1/n_last, so the complex-stage scale
    # must bring the NET inverse scaling to 1/total (backward), total**-0.5
    # (ortho), or 1.0 (forward).
    if norm in (None, "backward"):
        scale = 1.0 / (Xn * Yn)
    elif norm == "ortho":
        scale = total**-0.5 * n_last
    elif norm == "forward":
        scale = float(n_last)
    else:
        raise ValueError(f"invalid norm {norm!r}")

    def _c2r_tail(re2, im2):
        """Local Z-axis C2R of the [.., Xl, Yl, nb] half-spectrum."""
        from ..ops.rfft import irfft_last_split

        return irfft_last_split(re2[..., :nb], im2[..., :nb], n_last,
                                1.0 / n_last)

    def local(re, im):
        o = re.ndim - 3
        pad = (-re.shape[-1]) % mesh.devices.shape[1]
        if pad:
            pads = [(0, 0)] * (re.ndim - 1) + [(0, pad)]
            re2 = jnp.pad(re, pads)
            im2 = jnp.pad(im, pads)
        else:
            re2, im2 = re, im
        re2, im2 = _a2a((re2, im2), ay, o + 2, o + 1, comm)  # [.., Xl, Y, K/py]
        re2, im2 = _fft_then_a2a_chunked(                 # Y-FFT (pipelined)
            re2, im2, o + 1, INVERSE, None, ax, o + 1, o, o + 2, chunks, comm)
        # -> [.., X, Y/px, K/py]
        re2, im2 = _fft_axis_local(re2, im2, o, INVERSE, scale)
        re2, im2 = _a2a((re2, im2), ax, o, o + 1, comm)
        re2, im2 = _a2a((re2, im2), ay, o + 1, o + 2, comm)  # [.., X/px, Y/py, K]
        return _c2r_tail(re2, im2)

    def local_t(re2, im2):
        # mirror schedule from the transposed distribution
        # [.., X, Y/px, Kp/py] (Kp padded to a py multiple by the caller)
        o = re2.ndim - 3
        re2, im2 = _fft_then_a2a_chunked(                 # X-iFFT (scale)
            re2, im2, o, INVERSE, scale, ax, o, o + 1, o + 2, chunks, comm)
        re2, im2 = _fft_then_a2a_chunked(                 # Y-iFFT
            re2, im2, o + 1, INVERSE, None, ay, o + 1, o + 2, o, chunks,
            comm)                                         # [.., X/px, Y/py, Kp]
        return _c2r_tail(re2, im2)

    b = (None,) * lead
    natural = P(*b, ax, ay, None)
    if not transposed_input:
        fn = shard_map(local, mesh=mesh, in_specs=(natural, natural),
                       out_specs=natural)
        return jax.jit(fn)(re, im)

    transposed = P(*b, None, ax, ay)
    py = mesh.devices.shape[1]
    pad = (-nb) % py
    fn = shard_map(local_t, mesh=mesh, in_specs=(transposed, transposed),
                   out_specs=natural)

    def padded(a, b2):
        # re-pad the sliced half-spectrum axis to the a2a-divisible width
        # (the pad rows are zeros through every linear stage, exactly as
        # rfft3d produced them); padding at the end of a sharded axis
        # only grows the last shard — no inter-device movement.
        if pad:
            pads = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
            a = jnp.pad(a, pads)
            b2 = jnp.pad(b2, pads)
        return fn(a, b2)

    return jax.jit(padded)(re, im)
