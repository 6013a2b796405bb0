"""Native C++ host core: f64 table generation + plan factorization."""

import numpy as np
import pytest

from fft_wgpu_tpu.core import factor
from fft_wgpu_tpu.utils import native


def test_factor_balanced_split():
    assert factor.balanced_split(4096) == (64, 64)
    assert factor.balanced_split(2048) == (32, 64)
    assert factor.balanced_split(120) == (10, 12)
    assert factor.balanced_split(97) == (1, 97)  # prime


def test_radix_schedule():
    assert factor.radix_schedule(4096) == (128, 32)
    sched = factor.radix_schedule(120)
    assert np.prod(sched) == 120 and all(f <= 128 for f in sched)
    assert factor.radix_schedule(2 * 131) is None  # 131 prime > 128
    assert factor.is_smooth(1 << 22)


@pytest.mark.skipif(native.get_lib() is None, reason="no C++ toolchain")
def test_native_tables_match_numpy_f64():
    n = 16
    wr, wi = native.dft_matrix_f64(n, -1)
    k = np.arange(n)
    ref = np.exp(-2j * np.pi * np.outer(k, k) / n)
    assert np.abs(wr + 1j * wi - ref).max() < 1e-14

    tr, ti = native.twiddle_f64(4, 8, +1)
    reft = np.exp(+2j * np.pi * np.outer(np.arange(4), np.arange(8)) / 32)
    assert np.abs(tr + 1j * ti - reft).max() < 1e-14

    assert native.factorize(4096, 128) == [128, 32]
    assert native.factorize(262, 128) is None  # 2*131


# --------------------------------------------------------------------- #
# planar codec (one-pass threaded split/merge)
# --------------------------------------------------------------------- #

def test_host_split_merge_roundtrip():
    from fft_wgpu_tpu.utils.native import (get_lib, host_merge_complex,
                                           host_split_complex)

    if get_lib() is None:
        pytest.skip("native core unavailable")
    rng = np.random.default_rng(0)
    for dtype in (np.complex64, np.complex128):
        z = (rng.standard_normal((37, 129))
             + 1j * rng.standard_normal((37, 129))).astype(dtype)
        re, im = host_split_complex(z)
        assert re.dtype == np.float32 and re.shape == z.shape
        np.testing.assert_array_equal(re, z.real.astype(np.float32))
        np.testing.assert_array_equal(im, z.imag.astype(np.float32))
        back = host_merge_complex(re, im)
        assert back.dtype == np.complex64
        np.testing.assert_array_equal(back, z.astype(np.complex64))


def test_host_split_threaded_path():
    from fft_wgpu_tpu.utils.native import get_lib, host_split_complex

    if get_lib() is None:
        pytest.skip("native core unavailable")
    rng = np.random.default_rng(1)
    n = 1 << 21  # above the threading threshold
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    re, im = host_split_complex(z)
    np.testing.assert_array_equal(re, z.real)
    np.testing.assert_array_equal(im, z.imag)


def test_split_via_package_boundary():
    # complex_utils.split host path routes through the codec
    from fft_wgpu_tpu.core.complex_utils import split

    rng = np.random.default_rng(2)
    z = (rng.standard_normal(500) + 1j * rng.standard_normal(500)
         ).astype(np.complex64)
    re, im = split(z)
    np.testing.assert_allclose(np.asarray(re), z.real, rtol=0)
    np.testing.assert_allclose(np.asarray(im), z.imag, rtol=0)
