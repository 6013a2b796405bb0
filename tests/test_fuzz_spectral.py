"""Differential fuzz for the segment-spectrum surfaces (welch, csd,
coherence, spectrogram, stft, ShortTimeFFT) on the composed route:
framing, detrend and window as jnp ops, then the batched R2C/C2C through
`lax.fft`.  Random configurations across segment counts, overlaps,
nfft == / > nperseg, batched and complex inputs and both averages are
asserted against scipy.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.signal as sig


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (t, nperseg, hop, nfft, detrend, average, batch, complex)
CASES = [
    # exact one block of segments (num == 128 boundary)
    (512 * 1 + 127 * 256, 512, 256, 512, "constant", "mean", None, False),
    # num == 129: one-segment ragged tail
    (512 + 128 * 256, 512, 256, 512, "constant", "mean", None, False),
    # 8 overlapping segments per window, no detrend
    (8192, 512, 64, 512, False, "mean", None, False),
    # K == 1 with nfft zero-pad
    (6144, 512, 512, 1024, "constant", "mean", None, False),
    # median averaging
    (16384, 1024, 512, 1024, "constant", "median", None, False),
    # batched + complex input (two-sided C2C)
    (4096, 512, 256, 512, "constant", "mean", 3, True),
    # complex 1-D
    (8192, 1024, 512, 1024, False, "mean", None, True),
    # hop does not divide nperseg
    (8192, 600, 257, 600, "constant", "mean", None, False),
    # non-pow2 nfft
    (8192, 500, 250, 500, "constant", "mean", None, False),
    # linear detrend
    (8192, 512, 256, 512, "linear", "mean", None, False),
]


@pytest.mark.parametrize("t,nperseg,hop,nfft,detrend,average,batch,cplx",
                         CASES)
def test_welch_fuzz(rng, t, nperseg, hop, nfft, detrend,
                    average, batch, cplx):
    import fft_wgpu_tpu as ftt

    shape = (t,) if batch is None else (batch, t)
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    kw = dict(nperseg=nperseg, noverlap=nperseg - hop, nfft=nfft,
              detrend=detrend, average=average)
    f1, p1 = ftt.welch(x, **kw)
    f2, p2 = sig.welch(x, **kw)
    err = _rel(p1, p2)
    assert err < 1e-4, f"welch {err:.3e}"


@pytest.mark.parametrize("t,nperseg,hop,nfft,detrend,average,batch,cplx",
                         CASES[:7])
def test_spectrogram_fuzz(rng, t, nperseg, hop, nfft, detrend,
                          average, batch, cplx):
    import fft_wgpu_tpu as ftt

    shape = (t,) if batch is None else (batch, t)
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    kw = dict(nperseg=nperseg, noverlap=nperseg - hop, nfft=nfft,
              detrend=detrend)
    f1, t1, S1 = ftt.spectrogram(x, **kw)
    f2, t2, S2 = sig.spectrogram(x, **kw)
    assert np.asarray(S1).shape == S2.shape
    err = _rel(S1, S2)
    assert err < 1e-4, f"spectrogram {err:.3e}"


@pytest.mark.parametrize("t,nperseg,hop,nfft,detrend,average,batch,cplx",
                         [c for c in CASES if not c[7]][:6])
def test_csd_fuzz(rng, t, nperseg, hop, nfft, detrend, average,
                  batch, cplx):
    import fft_wgpu_tpu as ftt
    from fft_wgpu_tpu import device_get_complex as dget

    shape = (t,) if batch is None else (batch, t)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    kw = dict(nperseg=nperseg, noverlap=nperseg - hop, nfft=nfft,
              detrend=detrend)
    if average == "median":
        return  # scipy csd median differs only in bias handling; skip
    f1, c1 = ftt.csd(x, y, **kw)
    f2, c2 = sig.csd(x, y, **kw)
    err = _rel(dget(c1), c2)  # planar transfer (CLAUDE.md invariant)
    assert err < 1e-4, f"csd {err:.3e}"


@pytest.mark.parametrize("t,nperseg,hop,nfft,detrend", [
    (4096, 512, 256, 512, "constant"),
    (8192, 512, 128, 512, False),
    (4096, 512, 512, 512, "constant"),
    (4096, 512, 256, 1024, False),
    (6000, 400, 160, 400, "linear"),
])
def test_coherence_fuzz(rng, t, nperseg, hop, nfft, detrend):
    import fft_wgpu_tpu as ftt

    x = rng.standard_normal(t).astype(np.float32)
    y = (0.5 * x + rng.standard_normal(t)).astype(np.float32)
    kw = dict(nperseg=nperseg, noverlap=nperseg - hop, nfft=nfft,
              detrend=detrend)
    f1, c1 = ftt.coherence(x, y, **kw)
    f2, c2 = sig.coherence(x, y, **kw)
    assert np.allclose(np.asarray(f1), f2)
    assert _rel(c1, c2) < 1e-4


@pytest.mark.parametrize("mode", ["psd", "magnitude", "complex", "angle"])
def test_spectrogram_modes(rng, mode):
    import fft_wgpu_tpu as ftt
    from fft_wgpu_tpu import device_get_complex as dget

    x = rng.standard_normal(8192).astype(np.float32)
    f1, t1, S1 = ftt.spectrogram(x, nperseg=512, mode=mode)
    f2, t2, S2 = sig.spectrogram(x, nperseg=512, mode=mode)
    S1 = dget(S1) if mode == "complex" else np.asarray(S1)
    assert S1.shape == S2.shape
    assert _rel(S1, S2) < 1e-4


@pytest.mark.parametrize("batch", [None, 3])
def test_stft_frames_match_numpy(rng, batch):
    """stft: each frame is rfft(window * frame) (librosa-style layout
    [.., bins, frames], centered with reflect padding)."""
    import fft_wgpu_tpu as ftt
    from fft_wgpu_tpu import device_get_complex as dget

    n_fft, hop = 1024, 256
    shape = (8192,) if batch is None else (batch, 8192)
    x = rng.standard_normal(shape).astype(np.float32)
    Z = dget(ftt.stft(x, n_fft=n_fft, hop_length=hop))
    w = np.hanning(n_fft + 1)[:-1]
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)],
                mode="reflect")
    num = 1 + (xp.shape[-1] - n_fft) // hop
    assert Z.shape[-2:] == (n_fft // 2 + 1, num)
    for f in (0, num // 2, num - 1):
        want = np.fft.rfft(xp[..., f * hop: f * hop + n_fft] * w, axis=-1)
        assert _rel(Z[..., :, f], want) < 1e-4, f


@pytest.mark.parametrize("hop,mfft", [(128, 512), (100, 512), (128, 600)])
def test_short_time_fft_matches_scipy(rng, hop, mfft):
    import fft_wgpu_tpu as ftt
    from fft_wgpu_tpu import device_get_complex as dget

    win = sig.windows.hann(512, sym=False)
    x = rng.standard_normal(6000).astype(np.float32)
    mine = ftt.ShortTimeFFT(win, hop, 1.0, mfft=mfft)
    ref = sig.ShortTimeFFT(win, hop, 1.0, mfft=mfft)
    assert _rel(dget(mine.stft(x)), ref.stft(x)) < 1e-4
