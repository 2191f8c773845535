"""DFT matrices, twiddle factors, and radix factorization.

The reference (rchyena/offt) computes local 1-D transforms with FFTW plans
(offt-compute.c:329-489 ``setup_p1d``). The matmul engine
(kernels/stockham.py) expresses them as the *four-step / mixed-radix*
factorization where each small-radix DFT is a dense matmul: for N = N1*N2,

    X[k1 + N1*k2] = sum_n2 W_N2^(n2*k2) * [ W_N^(n2*k1) * sum_n1 x[n1*N2 + n2] * W_N1^(n1*k1) ]

so a length-N transform becomes a chain of (radix x radix) matmuls plus
elementwise twiddle multiplies. The distributed long-1-D engine
(dist/long1d.py) uses the same identity across devices. All constant tables (DFT matrices, twiddles) are generated here in
float64 numpy and cast to the target dtype so fp32 transforms keep ~1e-7
twiddle accuracy even at N = 2^20.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# Largest radix we realize as a dense DFT matmul; radices beyond this
# would blow up FLOPs (cost per element ~ radix).
MAX_RADIX = 128


def _prime_factors(n: int) -> list[int]:
    """Prime factorization of n (ascending)."""
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return fs


@functools.lru_cache(maxsize=None)
def factorize(n: int, max_radix: int = MAX_RADIX) -> tuple[int, ...]:
    """Factor n into a tuple of radices, each <= max_radix, product == n.

    Policy: first minimize the stage count (each stage in the unfused path
    is a full HBM read+write of the array), then *balance* the radices to
    minimize sum(radices) (matmul MACs per element = radix). E.g. 256 ->
    (16, 16), not (128, 2): same memory traffic, 4x less matmul work.
    Primes above max_radix are left in the list (the caller falls back to
    Bluestein for those). This is the *default* factorization; the tuner
    may override it (PlanParams.radix_*).
    """
    if n <= 0:
        raise ValueError(f"FFT length must be positive, got {n}")
    if n == 1:
        return (1,)
    primes = _prime_factors(n)
    big = [p for p in primes if p > max_radix]
    rest = [p for p in primes if p <= max_radix]
    if not rest:
        return tuple(sorted(big, reverse=True))
    # minimal number of stages k; then balance by greedily assigning primes
    # (largest first) to the currently-smallest bucket that still fits.
    prod = 1
    for p in rest:
        prod *= p
    k = 1
    while max_radix ** k < prod:
        k += 1
    for _ in range(len(rest)):  # k may be infeasible for awkward primes
        buckets = [1] * k
        ok = True
        for p in sorted(rest, reverse=True):
            cands = [i for i in range(k) if buckets[i] * p <= max_radix]
            if not cands:
                ok = False
                break
            tgt = min(cands, key=lambda i: buckets[i])
            buckets[tgt] *= p
        if ok:
            return tuple(sorted(buckets, reverse=True)) + tuple(
                sorted(big, reverse=True))
        k += 1
    raise AssertionError("unreachable: k == len(primes) always feasible")


def validate_factorization(n: int, radices: tuple[int, ...]) -> tuple[int, ...]:
    """Check a user/tuner-supplied radix list: product == n, each <= MAX_RADIX."""
    prod = 1
    for r in radices:
        prod *= r
    if prod != n:
        raise ValueError(f"radices {radices} do not multiply to {n}")
    return tuple(radices)


def is_supported_size(n: int, max_radix: int = MAX_RADIX) -> bool:
    """True if n factors entirely into radices <= max_radix (no Bluestein)."""
    return all(r <= max_radix for r in factorize(n, max_radix))


def dft_matrix(n: int, dtype, inverse: bool = False) -> np.ndarray:
    """Dense DFT matrix in the requested complex dtype (no 1/n scaling)."""
    k = np.arange(n, dtype=np.float64)
    kj = np.mod(np.outer(k, k), float(n))
    ang = (2.0 * math.pi / n) * kj
    m = np.cos(ang) + (1j if inverse else -1j) * np.sin(ang)
    return m.astype(dtype)


def twiddles(n1: int, n2: int, dtype, inverse: bool = False) -> np.ndarray:
    """Four-step twiddle table T[k1, n2] = exp(-+2i pi k1 n2 / (n1 n2))."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    kj = np.mod(np.outer(k1, j2), float(n))
    ang = (2.0 * math.pi / n) * kj
    t = np.cos(ang) + (1j if inverse else -1j) * np.sin(ang)
    return t.astype(dtype)


def flops_per_length(n: int, radices: tuple[int, ...] | None = None) -> int:
    """Complex MAC count per length-n transform under a radix factorization.

    The matmul engine's arithmetic cost. A radix-r
    stage costs r complex MACs per element (dense matmul), so total =
    n * sum(radices) complex MACs ~= 8 * n * sum(radices) real FLOPs.
    """
    rs = radices or factorize(n)
    return n * sum(rs)
