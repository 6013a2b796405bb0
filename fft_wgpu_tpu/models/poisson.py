"""Spectral Poisson solver — the canonical FFT-framework application.

Solves  laplacian(u) = f  on a periodic box via diagonalization in Fourier
space: u_hat = -f_hat / |k|^2 (zero-mean gauge).  Drives the full ND
R2C/C2R pipeline; on a mesh, the same math runs through the distributed
pencil transforms.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.nd import fftn, ifftn
from ..ops.rfft import irfftn, rfftn

__all__ = ["solve_poisson", "solve_poisson_distributed"]


def _ksq_grids(shape, lengths):
    """|k|^2 grid for an rfftn-shaped spectrum of a real field."""
    *rest, last = shape
    ks = []
    for n, L in zip(rest, lengths[:-1]):
        ks.append((2 * np.pi / L) * np.fft.fftfreq(n) * n)
    ks.append((2 * np.pi / lengths[-1]) * np.arange(last // 2 + 1))
    grids = np.meshgrid(*ks, indexing="ij")
    ksq = sum(g**2 for g in grids).astype(np.float32)
    ksq[(0,) * len(shape)] = 1.0  # avoid div-by-zero at the DC mode
    return jnp.asarray(ksq)


def solve_poisson(f, lengths=None):
    """u with laplacian(u) = f (periodic, zero-mean).  f: real [..grid..]."""
    f = jnp.asarray(f, jnp.float32)
    shape = f.shape
    lengths = lengths or (2 * math.pi,) * f.ndim
    ksq = _ksq_grids(shape, lengths)

    spec_shape = shape[:-1] + (shape[-1] // 2 + 1,)
    mask = np.ones(spec_shape, np.float32)
    mask[(0,) * len(shape)] = 0.0  # zero-mean gauge: kill the DC mode
    mask = jnp.asarray(mask)

    def impl(v):
        F = rfftn(v)
        U = -F / ksq.astype(F.dtype) * mask
        return irfftn(U, s=shape)

    return jax.jit(impl)(f)


def solve_poisson_distributed(f, mesh, lengths=None, *, comm_dtype=None):
    """Distributed 3-D Poisson solve via the pencil rfft3d/irfft3d pair.

    Rides the transposed-spectrum round trip (4 corner turns instead
    of 8 — parallel/pencil.py): the spectral divide is elementwise on the
    natural logical array, so the distribution never matters.
    `comm_dtype=bfloat16` additionally halves the wire bytes (see fft3d)."""
    from ..parallel.pencil import irfft3d, rfft3d

    f = jnp.asarray(f, jnp.float32)
    shape = f.shape
    lengths = lengths or (2 * math.pi,) * 3
    ksq = _ksq_grids(shape, lengths)

    F = rfft3d(f, mesh, transposed_output=True, comm_dtype=comm_dtype)
    mask = np.ones(F.shape, np.float32)
    mask[0, 0, 0] = 0.0
    U = -F / ksq.astype(F.dtype) * jnp.asarray(mask)
    return irfft3d(U, n_last=shape[-1], mesh=mesh, transposed_input=True,
                   comm_dtype=comm_dtype)
