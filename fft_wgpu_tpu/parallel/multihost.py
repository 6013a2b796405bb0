"""Multi-host (multi-process) bring-up helpers.

For pod-scale deployments each host process must join the cluster before
any mesh is built.  This is the distributed analogue of the reference's
single-process `prepare_gpu()` (fft_wgpu src/lib.rs:29-62).
"""

from __future__ import annotations

import jax

from .mesh import make_mesh, make_pencil_mesh

__all__ = ["initialize", "global_pencil_mesh"]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None):
    """Join the JAX distributed cluster (idempotent, env-driven defaults).

    Where no cluster manager tells JAX of the cluster, pass
    `coordinator_address` (e.g. "localhost:<port>"), `num_processes` and
    `process_id` explicitly.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return jax.process_index(), jax.process_count()


def global_pencil_mesh(axis_names=("px", "py")):
    """Pencil mesh over every device in the cluster (all hosts).

    Mesh axes are laid out so the all-to-all corner turns of
    parallel.pencil stay within a host's NVLink island wherever possible.
    """
    return make_pencil_mesh(jax.devices(), axis_names=axis_names)
