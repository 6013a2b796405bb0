// Native host-side core for the FFT framework.
//
// Role (the analogue of the reference's Rust host layer):
//   * f64 trigonometric table generation — mirrors the reference's host-side
//     f64 twiddle precompute (fft_wgpu src/processor.rs:43-49) at full
//     double precision before the single cast to f32 on the Python side.
//   * mixed-radix plan factorization — the planning role the reference's
//     pipeline factories play (src/processor.rs:161-229), picking the radix
//     schedule of the JAX matmul recursion (ops/stockham.py).
//
// Exposed through a plain C ABI and loaded via ctypes (no pybind11).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// W[k*n + m] = exp(sign * 2*pi*i * k*m / n), split into cos/sin planes.
// Uses the angle reduction k*m mod n so large k*m products never lose
// precision (important for n up to 2^22+).
void fftcore_dft_matrix(int64_t n, int sign, double* wr, double* wi) {
  const double step = sign * 2.0 * M_PI / static_cast<double>(n);
  for (int64_t k = 0; k < n; ++k) {
    for (int64_t m = 0; m < n; ++m) {
      const int64_t r = (k * m) % n;
      const double theta = step * static_cast<double>(r);
      wr[k * n + m] = std::cos(theta);
      wi[k * n + m] = std::sin(theta);
    }
  }
}

// tw[k1*n2 + m2] = exp(sign * 2*pi*i * k1*m2 / (n1*n2))
void fftcore_twiddle(int64_t n1, int64_t n2, int sign, double* wr, double* wi) {
  const int64_t n = n1 * n2;
  const double step = sign * 2.0 * M_PI / static_cast<double>(n);
  for (int64_t k = 0; k < n1; ++k) {
    for (int64_t m = 0; m < n2; ++m) {
      const int64_t r = (k * m) % n;
      const double theta = step * static_cast<double>(r);
      wr[k * n2 + m] = std::cos(theta);
      wi[k * n2 + m] = std::sin(theta);
    }
  }
}

// Greedy largest-first radix schedule: factors of n, each <= max_radix,
// preferring large power-of-two radices (128, 64, ...), then odd primes.
// Returns the number of factors written, or -1 if n has a prime factor
// > max_radix (caller falls back to direct DFT / Bluestein).
int64_t fftcore_factorize(int64_t n, int64_t max_radix, int64_t* out,
                          int64_t cap) {
  int64_t cnt = 0;
  if (n <= 1) return 0;
  while (n > 1 && cnt < cap) {
    int64_t f = 0;
    for (int64_t r = (n < max_radix ? n : max_radix); r >= 2; --r) {
      if (n % r == 0) {
        f = r;
        break;
      }
    }
    if (f == 0) return -1;  // prime factor larger than max_radix
    out[cnt++] = f;
    n /= f;
  }
  return (n == 1) ? cnt : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Planar codec: host-side complex interleave <-> planar split.
//
// The serving boundary moves complex data as planar (re, im) float32
// (the split-domain executors' layout); numpy's
// z.real/z.imag does two strided passes and the merge allocates complex
// temporaries.  These do it in one threaded pass each — the native
// analogue of the reference's staging-buffer pack/unpack
// (fft_wgpu examples/basic.rs:84-122).
// ---------------------------------------------------------------------

namespace {

template <typename F>
void parallel_chunks(int64_t n, int threads, F&& body) {
  if (threads <= 1 || n < (1LL << 20)) {
    body(0, n);
    return;
  }
  int64_t chunk = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&, lo, hi] { body(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void fftcore_split_c64(const float* z, float* re, float* im, int64_t n,
                       int threads) {
  parallel_chunks(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      re[i] = z[2 * i];
      im[i] = z[2 * i + 1];
    }
  });
}

void fftcore_split_c128(const double* z, float* re, float* im, int64_t n,
                        int threads) {
  parallel_chunks(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      re[i] = static_cast<float>(z[2 * i]);
      im[i] = static_cast<float>(z[2 * i + 1]);
    }
  });
}

void fftcore_merge_c64(const float* re, const float* im, float* z, int64_t n,
                       int threads) {
  parallel_chunks(n, threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      z[2 * i] = re[i];
      z[2 * i + 1] = im[i];
    }
  });
}

}  // extern "C"
