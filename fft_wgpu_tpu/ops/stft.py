"""STFT / ISTFT and window functions (scipy.signal-style semantics).

Framework completeness layer: short-time transforms built on the batched
R2C pipeline — framing is a reshape/gather, the hot loop is the batched
R2C, and everything composes under one jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .rfft import irfft, rfft

__all__ = ["hann_window", "hamming_window", "blackman_window", "bartlett_window", "stft", "istft"]


def hann_window(n: int, *, periodic: bool = True):
    """Hann window (periodic=True matches scipy fftbins=True)."""
    if n == 1:
        return jnp.ones((1,), jnp.float32)  # numpy parity; avoids m == 0
    m = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return jnp.asarray((0.5 - 0.5 * np.cos(2 * np.pi * k / m)).astype(np.float32))


def hamming_window(n: int, *, periodic: bool = True):
    """Hamming window (periodic=True matches scipy fftbins=True)."""
    if n == 1:
        return jnp.ones((1,), jnp.float32)  # numpy parity; avoids m == 0
    m = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return jnp.asarray((0.54 - 0.46 * np.cos(2 * np.pi * k / m)).astype(np.float32))


def blackman_window(n: int, *, periodic: bool = True):
    """Blackman window (periodic=True matches scipy fftbins=True)."""
    if n == 1:
        return jnp.ones((1,), jnp.float32)  # numpy parity; avoids m == 0
    m = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    w = 0.42 - 0.5 * np.cos(2 * np.pi * k / m) + 0.08 * np.cos(4 * np.pi * k / m)
    return jnp.asarray(w.astype(np.float32))


def bartlett_window(n: int, *, periodic: bool = True):
    """Bartlett (triangular) window (periodic=True = scipy fftbins)."""
    if n == 1:
        return jnp.ones((1,), jnp.float32)  # numpy parity; avoids m == 0
    m = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return jnp.asarray((1.0 - np.abs(2.0 * k / m - 1.0)).astype(np.float32))


def _frame(x, frame_len: int, hop: int):
    """[..., t] -> [..., num_frames, frame_len] by strided windowing.

    GATHER-FREE for ANY hop: framing is K = ceil(frame_len/hop) shifted
    slices of a hop-chunked view, concatenated and sliced to frame_len,
    in place of a flat-index gather."""
    t = x.shape[-1]
    if t < frame_len:
        raise ValueError(
            f"signal length {t} is shorter than n_fft={frame_len}; "
            "pad the input or pass center=True"
        )
    num = 1 + (t - frame_len) // hop
    K = -(-frame_len // hop)
    chunks = (num + K - 1) * hop  # samples the chunk view must cover
    if chunks > t:  # hop !| frame_len: zero-pad the tail chunks; the
        pad = [(0, 0)] * (x.ndim - 1) + [(0, chunks - t)]  # pad only
        x = jnp.pad(x, pad)  # lands in columns >= frame_len (sliced off)
    v = x[..., :chunks].reshape(*x.shape[:-1], num + K - 1, hop)
    parts = [v[..., k : k + num, :] for k in range(K)]
    out = jnp.concatenate(
        [p[..., None, :] for p in parts], axis=-2
    ).reshape(*x.shape[:-1], num, K * hop)
    return out[..., :frame_len]


def _ola_slabs(frames, hop: int, t: int):
    """Scatter-free overlap-add of [..., num, flen] frames at stride
    `hop` into [..., t]: pad frames to K*hop and accumulate K contiguous
    shifted slabs, in place of a flat-index .at[idx].add scatter."""
    num, flen = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    K = -(-flen // hop)
    fp = jnp.pad(frames, [(0, 0)] * (frames.ndim - 1)
                 + [(0, K * hop - flen)])
    ch = fp.reshape(*lead, num, K, hop)
    out = jnp.zeros((*lead, num + K - 1, hop), frames.dtype)
    for k in range(K):
        out = out.at[..., k : k + num, :].add(ch[..., :, k, :])
    return out.reshape(*lead, (num + K - 1) * hop)[..., :t]


def _prep_window(window, n_fft, win_length):
    """Resolve the analysis window to length n_fft: default hann of
    win_length (or n_fft), and any window shorter than n_fft is padded
    centered (torch.stft win_length semantics)."""
    if window is None:
        window = hann_window(win_length or n_fft)
    window = jnp.asarray(window, jnp.float32)
    wl = window.shape[0]
    if win_length is not None and wl != win_length:
        raise ValueError(f"window length {wl} != win_length {win_length}")
    if wl > n_fft:
        raise ValueError(f"window length {wl} exceeds n_fft {n_fft}")
    if wl < n_fft:
        left = (n_fft - wl) // 2
        window = jnp.pad(window, (left, n_fft - wl - left))
    return window


def stft(x, n_fft: int = 512, hop_length: int | None = None, window=None,
         center: bool = True, win_length: int | None = None):
    """Short-time Fourier transform of a real signal.

    Returns complex [..., n_fft//2 + 1, num_frames] (librosa-style layout).
    """
    hop = hop_length or n_fft // 4
    x = jnp.asarray(x, jnp.float32)
    window = _prep_window(window, n_fft, win_length)
    if center:
        pad = [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        x = jnp.pad(x, pad, mode="reflect")

    def impl(v):
        frames = _frame(v, n_fft, hop) * window  # [..., num, n_fft]
        spec = rfft(frames, axis=-1)             # [..., num, n_fft//2+1]
        return jnp.swapaxes(spec, -1, -2)

    from ..utils.jit_cache import cached_call, shape_key

    key = ("stft", jax.default_backend(), shape_key(x), n_fft, hop,
           center, bytes(np.asarray(window).tobytes()))
    return cached_call(key, impl, x)


def istft(Z, n_fft: int = 512, hop_length: int | None = None, window=None,
          center: bool = True, length: int | None = None,
          win_length: int | None = None):
    """Inverse STFT via windowed overlap-add (COLA normalization)."""
    hop = hop_length or n_fft // 4
    window = _prep_window(window, n_fft, win_length)

    def impl(zr, zi):
        # merged inside jit: complex arrays never cross host<->device
        spec = jax.lax.complex(zr, zi)
        frames = irfft(jnp.swapaxes(spec, -1, -2), n=n_fft, axis=-1)
        frames = frames * window  # [..., num, n_fft]
        num = frames.shape[-2]
        t = n_fft + hop * (num - 1)
        lead = frames.shape[:-2]

        wsq = (np.asarray(window) ** 2).astype(np.float32)
        norm = np.zeros(t, np.float32)
        np.add.at(norm,
                  (np.arange(num)[:, None] * hop
                   + np.arange(n_fft)[None, :]).ravel(),
                  np.tile(wsq, num))
        norm = np.where(norm > 1e-8, norm, 1.0)

        if n_fft % hop == 0:
            # scatter-free overlap-add: chunk frames into K hop-slices and
            # accumulate K contiguous shifted slabs (no flat-index
            # scatter)
            K = n_fft // hop
            ch = frames.reshape(*lead, num, K, hop)
            out = jnp.zeros((*lead, num + K - 1, hop), jnp.float32)
            for k in range(K):
                out = out.at[..., k : k + num, :].add(ch[..., :, k, :])
            out = out.reshape(*lead, (num + K - 1) * hop)
        else:
            # hop !| n_fft: the generalized scatter-free slab OLA
            out = _ola_slabs(frames, hop, t)
        return out / jnp.asarray(norm)

    from ..core.complex_utils import promote_to_split

    zr, zi = promote_to_split(Z)  # host complex split on host (CLAUDE.md)
    from ..utils.jit_cache import cached_call, shape_key

    key = ("istft", jax.default_backend(), shape_key(zr), n_fft, hop,
           bytes(np.asarray(window).tobytes()))
    y = cached_call(key, impl, zr, zi)
    if center:
        # trim the left reflect-pad; the RIGHT trim happens via length
        # below when given — torch serves length= from the right-pad
        # region's reconstructed samples before it would ever zero-pad
        y = y[..., n_fft // 2:]
        if length is None:
            y = y[..., : y.shape[-1] - n_fft // 2]
    if length is not None:
        if y.shape[-1] < length:
            pad = [(0, 0)] * (y.ndim - 1) + [(0, length - y.shape[-1])]
            y = jnp.pad(y, pad)
        y = y[..., :length]
    return y
