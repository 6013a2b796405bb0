"""Spectral-analysis serving pipeline: welch, coherence, spectrogram,
stft round trip, a matched filter and the fast dot-precision mode, each
one jitted program over the library's batched R2C.

Run:  python examples/spectral_pipeline.py   (GPU or CPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fft_wgpu_tpu as ftt


def main():
    rng = np.random.default_rng(0)
    fs = 10_000.0
    t = np.arange(1 << 20) / fs
    # two tones + band noise, plus a correlated channel
    x = (np.sin(2 * np.pi * 440.0 * t) + 0.5 * np.sin(2 * np.pi * 1250.0 * t)
         + 0.3 * rng.standard_normal(t.size)).astype(np.float32)
    y = (0.7 * x + 0.3 * rng.standard_normal(t.size)).astype(np.float32)

    # ---- Welch PSD ----
    f, pxx = ftt.welch(x, fs=fs, nperseg=4096)
    fa, pa = np.asarray(f), np.asarray(pxx)
    p440 = fa[np.argmax(np.where((fa > 300) & (fa < 600), pa, 0.0))]
    p1250 = fa[np.argmax(np.where((fa > 1000) & (fa < 1500), pa, 0.0))]
    print(f"welch peaks: {p440:.1f} Hz and {p1250:.1f} Hz "
          f"(expect 440, 1250)")
    assert abs(p440 - 440.0) < 5 and abs(p1250 - 1250.0) < 5

    # ---- coherence (Pxy, Pxx, Pyy) ----
    f, cxy = ftt.coherence(x, y, fs=fs, nperseg=4096)
    c440 = float(np.asarray(cxy)[np.argmin(np.abs(np.asarray(f) - 440.0))])
    print(f"coherence at 440 Hz: {c440:.3f} (strong: tone is shared)")
    assert c440 > 0.9

    # ---- spectrogram (per-segment power spectra) ----
    f, tt, S = ftt.spectrogram(x, fs=fs, nperseg=1024, noverlap=512)
    print(f"spectrogram: {np.asarray(S).shape} (bins x segments)")

    # ---- STFT round trip (framed R2C; scatter-free OLA back) ----
    Z = ftt.stft(x[: 1 << 16], n_fft=512, hop_length=128)
    xr = np.asarray(ftt.istft(Z, n_fft=512, hop_length=128,
                              length=1 << 16))
    err = np.linalg.norm(xr - x[: 1 << 16]) / np.linalg.norm(x[: 1 << 16])
    print(f"stft->istft roundtrip rel-L2: {err:.2e}")
    assert err < 1e-5

    # ---- matched filter via oaconvolve (scatter-free overlap-add) ----
    h = np.sin(2 * np.pi * 440.0 * np.arange(129) / fs).astype(np.float32)
    det = np.asarray(ftt.oaconvolve(x, h[::-1].copy(), mode="same"))
    print(f"matched filter output power: {float((det**2).mean()):.3f}")

    # ---- fast dot precision: the matmul executors at DEFAULT (TF32 on
    #      an H100); welch runs on lax.fft, so nothing changes here ----
    with ftt.dot_precision("fast"):
        f, pxx_fast = ftt.welch(x, fs=fs, nperseg=4096)
    rel = (np.linalg.norm(np.asarray(pxx_fast) - np.asarray(pxx))
           / np.linalg.norm(np.asarray(pxx)))
    print(f"fast-precision welch vs accurate: rel {rel:.1e}")
    assert rel < 0.05


if __name__ == "__main__":
    main()
