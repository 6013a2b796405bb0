"""Roofline accounting for FFT benchmarks.

The reference times wall-clock including H2D/D2H per iteration
(examples/basic.rs:70-129); here device-time-only measurement is compared
against the HBM-bandwidth roofline (the binding resource for a fused
batched FFT): a C2C FFT must read and write every complex element once,
so t_min = 2 * batch * n * 8 bytes / BW, and the conventional rate is
5 N log2 N flops (BASELINE.json metric).
"""

from __future__ import annotations

import math

import jax

__all__ = ["hbm_bandwidth", "fft_flops", "roofline", "link_bandwidth",
           "pencil_fft3d_model"]

# Published peaks by `device_kind` (NVIDIA H100 data sheet; rates assume
# the card's full power limit):
#   hbm     device-memory bandwidth, bytes/s
#   link    NVLink bandwidth to the other cards of the host, each way, all
#           to all (900 GB/s total = 450 GB/s each way), bytes/s; None where
#           the part has no all-to-all NVLink
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "link": 4.5e11},  # SXM5
    "NVIDIA H100 PCIe": {"hbm": 2.0e12, "link": None},
}


def _peaks(device):
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", None)
    if kind not in _PEAKS:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; known kinds: "
            f"{sorted(_PEAKS)}")
    return _PEAKS[kind]


def hbm_bandwidth(device=None) -> float:
    """Published device-memory bandwidth (bytes/s) of `device` (default:
    the first JAX device).  Raises ValueError for a kind not in the
    table: there is no default."""
    return _peaks(device)["hbm"]


def fft_flops(n: int, batch: int = 1) -> float:
    """Conventional FFT flop count 5 N log2 N per transform."""
    return 5.0 * n * math.log2(n) * batch


def roofline(n: int, batch: int, seconds: float, *, passes: int = 1, device=None):
    """Return dict with achieved GFLOP/s, roofline GFLOP/s, and fraction.

    `passes` = HBM round trips the algorithm fundamentally needs (1 for a
    single-pass transform, ~3 for four-step)."""
    bw = hbm_bandwidth(device)
    flops = fft_flops(n, batch)
    bytes_min = 2.0 * batch * n * 8.0 * passes  # read + write, complex64
    t_min = bytes_min / bw
    achieved = flops / seconds
    roof = flops / t_min
    return {
        "gflops": achieved / 1e9,
        "roofline_gflops": roof / 1e9,
        "fraction": achieved / roof,
        "t_min_s": t_min,
        "bandwidth": bw,
    }


def link_bandwidth(device=None) -> float:
    """Published NVLink bandwidth (bytes/s) from one card to the others,
    each way.  Raises ValueError where the kind has none."""
    bw = _peaks(device)["link"]
    if bw is None:
        raise ValueError("this device kind has no all-to-all NVLink")
    return bw


def pencil_fft3d_model(n: int, mesh_shape: tuple[int, int], *, device=None,
                       transposed_output: bool = False,
                       hbm_bw: float | None = None,
                       link_bw: float | None = None,
                       comm_bytes: float = 8.0) -> dict:
    """Lower-bound cost model for the pencil-decomposed 3-D C2C FFT of an
    n^3 cube over a px x py mesh (parallel/pencil.py:_fft3d_impl).

    Floors, per chip, split-complex f32 (8 B/point):
      - compute: 3 local pencil-FFT passes, each one HBM read + write of
        the full local slice;
      - link: each `all_to_all` along a mesh axis of size m sends
        (m-1)/m of the local slice off the card at the card's one-way
        NVLink bandwidth (every card reaches every other at the same
        rate, so the mesh shape does not split it).  2 corner turns for
        transposed output, 4 for natural order.  `comm_bytes` is the
        wire size per complex point (8 for split f32, 4 for the
        comm_dtype=bf16 opt-in turns — pencil.py:_a2a).
    With the chunked overlap schedule (`overlap_chunks`) the total floor
    is max(compute, link) + one chunk of exposed latency ~= max(...).

    Returns times in seconds plus the modeled per-chip byte counts.
    """
    px, py = mesh_shape
    p = px * py
    hbm = hbm_bw or hbm_bandwidth(device)
    link = link_bw or link_bandwidth(device)

    local_bytes = 8.0 * n**3 / p
    compute_s = 3.0 * 2.0 * local_bytes / hbm

    turns = [(py, "Z->Y"), (px, "Y->X")]
    if not transposed_output:
        turns += [(px, "X out"), (py, "Y out")]
    wire_bytes = local_bytes * comm_bytes / 8.0
    link_bytes = sum(wire_bytes * (m - 1) / m for m, _ in turns)
    link_s = link_bytes / link

    overlapped_s = max(compute_s, link_s)
    return {
        "chips": p,
        "local_bytes": local_bytes,
        "compute_s": compute_s,
        "link_s": link_s,
        "link_bytes_per_chip": link_bytes,
        "overlapped_s": overlapped_s,
        "serial_s": compute_s + link_s,
        # 3 axes x (n^2 rows x 5 n log2 n) = 5 n^3 log2(n^3)
        "gflops": 15.0 * n**3 * math.log2(n) / overlapped_s / 1e9,
    }
