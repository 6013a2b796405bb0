"""Multirate / filtering tour: design an anti-alias FIR, rational-rate
resample an audio-style signal, decimate, and route stock jnp.fft call
sites through the framework.

New capability vs the reference (a bare batched FFT, SURVEY §2): the
full scipy.signal multirate surface on the library's FFT path —
firwin/firwin2 design, FFT-based upfirdn, resample_poly, decimate —
plus the opt-in jnp.fft router.

Run (CPU is fine): PYTHONPATH=. JAX_PLATFORMS=cpu python examples/multirate_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fft_wgpu_tpu as ftt


def main():
    fs = 48_000.0
    t = np.arange(int(0.05 * fs)) / fs  # 50 ms
    # two tones: one inside the post-resample band, one that MUST alias
    # away if the anti-alias filter works
    sig = (np.sin(2 * np.pi * 3_000 * t)
           + 0.5 * np.sin(2 * np.pi * 21_000 * t)).astype(np.float32)

    # 48 kHz -> 32 kHz (up 2 / down 3): the 21 kHz tone exceeds the new
    # 16 kHz Nyquist and must be suppressed by the kaiser anti-alias FIR
    y = np.asarray(ftt.resample_poly(sig, 2, 3))
    print(f"resample_poly: {len(sig)} @48k -> {len(y)} @32k")

    spec = np.abs(np.asarray(ftt.rfft(y)))
    f = np.asarray(ftt.rfftfreq(len(y), d=3 / (2 * fs)))
    keep = spec[np.argmin(np.abs(f - 3_000))]
    alias_band = spec[f > 10_000].max()
    print(f"3 kHz tone kept: {keep:.1f}; residual above 10 kHz: "
          f"{alias_band:.2e} ({20*np.log10(alias_band/keep):.0f} dB)")
    assert alias_band < 1e-2 * keep

    # custom design: 80 dB-stopband kaiser lowpass via the width= handle
    h = ftt.firwin(121, 8_000.0, width=2_000.0, fs=fs)
    lp = np.asarray(ftt.upfirdn(h, sig))  # plain FIR filtering (up=down=1)
    print(f"firwin taps: {len(h)}, filtered len: {len(lp)}")

    # decimate 4x with the FIR path (zero-phase)
    d = np.asarray(ftt.decimate(sig, 4))
    print(f"decimate 4x: {len(sig)} -> {len(d)}")

    # route existing jnp.fft call sites through the framework
    import jax.numpy as jnp

    import fft_wgpu_tpu.jnp_backend as jb

    with jb.accelerated():
        X = jnp.fft.rfft(jnp.asarray(sig))  # runs on ftt's kernels
    ref = np.fft.rfft(sig)
    rel = np.linalg.norm(np.asarray(X) - ref) / np.linalg.norm(ref)
    print(f"jnp_backend rfft rel vs numpy: {rel:.2e}")
    assert rel < 1e-5
    print("multirate demo ok")


if __name__ == "__main__":
    main()
