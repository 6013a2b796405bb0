"""Mixed-radix factorization for plan construction.

The reference supports power-of-two lengths only (stage count =
log2(fft_len), fft_wgpu src/processor.rs:327).  We generalize: any length
whose prime factors are <= MAX_DIRECT runs the mixed-radix recursion; other
lengths fall back to Bluestein or a direct O(N^2) DFT matmul.
"""

from __future__ import annotations

import functools
import math

from ..utils import native

# Largest base-case DFT executed as a single direct matmul in the recursion.
MAX_DIRECT = 128


@functools.lru_cache(maxsize=None)
def balanced_split(n: int) -> tuple[int, int]:
    """Split n = n1 * n2 with n1 <= n2, n1 as close to sqrt(n) as possible.

    Returns (1, n) when n is prime (caller uses the direct-DFT fallback).
    """
    best = 1
    r = int(math.isqrt(n))
    for d in range(r, 1, -1):
        if n % d == 0:
            best = d
            break
    return best, n // best


@functools.lru_cache(maxsize=None)
def radix_schedule(n: int, max_radix: int = MAX_DIRECT) -> tuple[int, ...] | None:
    """Greedy largest-first factor list with every factor <= max_radix,
    or None if n contains a prime factor > max_radix."""
    sched = native.factorize(n, max_radix)
    if sched is not None:
        return tuple(sched)
    out = []
    m = n
    while m > 1:
        f = 0
        for r in range(min(m, max_radix), 1, -1):
            if m % r == 0:
                f = r
                break
        if f == 0:
            return None
        out.append(f)
        m //= f
    return tuple(out)


def is_smooth(n: int, max_radix: int = MAX_DIRECT) -> bool:
    return radix_schedule(n, max_radix) is not None
