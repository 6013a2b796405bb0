"""Device mesh construction helpers.

The reference is single-device (one adapter/queue ever created —
fft_wgpu src/lib.rs:38-59); multi-chip execution is a new first-class
subsystem here (SURVEY §2 parallelism checklist).  Meshes are the
`prepare_gpu()` analogue: build once, pass to the distributed transforms.
The cards of one host are joined all to all by NVLink, so a mesh's shape
follows the algorithm alone.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "make_pencil_mesh", "make_hybrid_mesh"]


def make_mesh(shape=None, axis_names=("x",), devices=None) -> Mesh:
    """Build a Mesh over `devices` (default: all).

    `shape=None` uses all devices on one axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
    if math.prod(shape) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names)


def make_pencil_mesh(devices=None, axis_names=("px", "py")) -> Mesh:
    """2-D mesh as square as possible — the pencil-decomposition layout
    (BASELINE.json config 5: the all-to-all corner turns ride both mesh
    axes)."""
    devices = list(devices if devices is not None else jax.devices())
    nd = len(devices)
    p1 = 1
    for d in range(int(math.isqrt(nd)), 0, -1):
        if nd % d == 0:
            p1 = d
            break
    return make_mesh((p1, nd // p1), axis_names, devices)


def make_hybrid_mesh(axis_names=("hosts", "nvlink"), devices=None) -> Mesh:
    """Multi-host 2-D mesh: the MINOR axis holds the cards of one host
    (an NVLink island, where collectives along it stay on NVLink), the
    MAJOR axis crosses hosts (the network).

    Host membership comes from each device's `process_index` (one JAX
    process per host); a single-process deployment — one host's cards,
    the virtual CPU mesh — is ONE host, i.e. a [1, n] mesh whose minor
    axis is all NVLink.  For the pencil transforms, lay shardings out so
    the X<->Y corner turn (the per-step all-to-all) maps to the 'nvlink'
    axis and only batch/outer parallelism to 'hosts' — the network
    between hosts is an order of magnitude slower than NVLink.
    """
    devices = list(devices if devices is not None else jax.devices())
    hosts: dict = {}
    for d in devices:
        hosts.setdefault(d.process_index, []).append(d)
    counts = {len(v) for v in hosts.values()}
    if len(counts) != 1:
        raise ValueError(
            f"uneven hosts: {sorted((k, len(v)) for k, v in hosts.items())}")
    per = counts.pop()
    ordered = [d for k in sorted(hosts) for d in hosts[k]]
    return make_mesh((len(hosts), per), axis_names, ordered)
