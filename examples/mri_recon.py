"""Non-Cartesian MRI-style reconstruction demo on the NUFFT stack.

Simulates radial k-space sampling of a Shepp-Logan-ish phantom, then
reconstructs by density-compensated adjoint NUFFT (gridding) — the
classic non-Cartesian imaging pipeline, all on the framework:

    k-space data  y_j = (type-2 NUFFT)(image)        [forward model]
    recon         x^  = (type-1 NUFFT)(w_j * y_j)    [adjoint + DCF]

Run: python examples/mri_recon.py   (CPU or GPU; prints PSNR)
"""
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import fft_wgpu_tpu as ftt


def phantom(n):
    """Simple analytic phantom: three Gaussian blobs + a rectangle."""
    yy, xx = np.mgrid[0:n, 0:n] / n - 0.5
    img = np.zeros((n, n), np.float32)
    for (cx, cy, sx, sy, a) in [(-0.12, 0.0, 0.18, 0.25, 1.0),
                                (0.15, 0.1, 0.08, 0.06, 0.7),
                                (0.1, -0.18, 0.05, 0.09, 0.5)]:
        img += a * np.exp(-(((xx - cx) / sx) ** 2 + ((yy - cy) / sy) ** 2))
    img[(np.abs(xx + 0.3) < 0.06) & (np.abs(yy) < 0.2)] += 0.6
    return img


def radial_trajectory(n_spokes, n_read, n):
    """Radial spokes through k-space center; returns mode-units (kx, ky)
    in [-n/2, n/2) and the standard ramp density compensation."""
    ang = np.pi * np.arange(n_spokes) / n_spokes
    r = (np.arange(n_read) - n_read / 2) / n_read * n  # [-n/2, n/2)
    kx = (r[None, :] * np.cos(ang[:, None])).ravel()
    ky = (r[None, :] * np.sin(ang[:, None])).ravel()
    dcf = np.abs(np.tile(r, n_spokes)) + 0.5  # ramp filter
    return kx.astype(np.float32), ky.astype(np.float32), dcf.astype(np.float32)


def main():
    n = 128
    img = phantom(n)
    kx, ky, dcf = radial_trajectory(2 * n, 2 * n, n)

    # forward model: image modes -> k-space samples at (kx, ky).
    # nufft2d2 takes POINT coordinates in radians; mode-units k map to
    # points x = 2pi k / n of the conjugate variable (see module doc).
    xp = (2 * np.pi / n) * kx
    yp = (2 * np.pi / n) * ky
    y = np.asarray(ftt.device_get_complex(ftt.nufft2d2(xp, yp, img.astype(np.complex64))))

    # adjoint recon with density compensation
    rec = np.asarray(ftt.device_get_complex(
        ftt.nufft2d1(xp, yp, (y * dcf).astype(np.complex64), (n, n))))
    rec = np.abs(rec)
    rec *= img.mean() / max(rec.mean(), 1e-12)  # DC gain normalization

    err = np.linalg.norm(rec - img) / np.linalg.norm(img)
    psnr = 20 * np.log10(img.max() / (np.sqrt(np.mean((rec - img) ** 2)) + 1e-12))
    print(f"radial spokes={2*n}, read={2*n}, grid {n}x{n}: "
          f"rel L2 {err:.3f}, PSNR {psnr:.1f} dB")
    assert psnr > 15.0, "gridding recon should be recognizable"


if __name__ == "__main__":
    main()
