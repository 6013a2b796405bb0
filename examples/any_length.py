"""Any-length FFT demo: non-power-of-two n.

The reference supports powers of two only (stage count = log2(fft_len),
fft_wgpu src/processor.rs:327).  This framework covers every length: the
default route is XLA's FFT (cuFFT on the GPU), which takes any n, and the
chirp-z transform composes two power-of-two FFTs.  All verified here
against numpy.

Run: python examples/any_length.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fft_wgpu_tpu as ftt


def check(tag, got, want, tol=1e-5):
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < tol, f"{tag}: rel {rel:.2e} >= {tol}"
    print(f"  {tag}: rel {rel:.2e}")


def main():
    rng = np.random.default_rng(0)
    rows = 16

    print("C2C, one length per class:")
    for n, why in [
        (4096, "power of two"),
        (4095, "63*65"),
        (4093, "prime"),
        (4097, "17*241"),
        (1000, "25*40"),
    ]:
        x = (rng.standard_normal((rows, n))
             + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
        got = ftt.device_get_complex(ftt.fft(x))
        check(f"fft n={n:5d} ({why})", got, np.fft.fft(x, axis=-1))

    print("R2C on an odd composite length:")
    xr = rng.standard_normal((rows, 1005)).astype(np.float32)
    got = ftt.device_get_complex(ftt.rfft(xr))
    check("rfft n=1005 (15*67)", got,
          np.fft.rfft(xr, axis=-1))

    print("CZT (chirp-z over power-of-two FFTs):")
    x = (rng.standard_normal((rows, 700))
         + 1j * rng.standard_normal((rows, 700))).astype(np.complex64)
    import scipy.signal as sig

    got = ftt.device_get_complex(ftt.czt(x, m=450))
    check("czt 700 -> 450 bins", got,
          sig.czt(np.asarray(x, np.complex128), m=450), tol=1e-4)

    print("all lengths verified")


if __name__ == "__main__":
    main()
