"""Mixed-radix 1-D FFT as a chain of matmuls (four-step / Stockham).

The matmul engine: the alternative to XLA's own FFT for the reference's
FFTW 1-D sub-plans (``setup_p1d``, /root/reference/offt-compute.c:329-489).
Each radix stage is a dense (r x r) DFT matmul batched over all pencils,
followed by an elementwise twiddle multiply that XLA fuses into the
matmul epilogue, so an N = r1*r2*...*rk transform touches device memory
O(k) times instead of O(log2 N).

The recursion (decimation in time, self-sorting via reshape/transpose):

    x: (..., N) with N = r * m
    y[k1, n2]  = sum_n1 F_r[k1, n1] * x[n1 * m + n2]        (matmul)
    y[k1, n2] *= W_N^(k1 * n2)                               (elementwise)
    z[k1, k2]  = fft_m(y[k1, :])                             (recurse)
    X[k2 * r + k1] = z[k1, k2]                               (transpose)

All tables come from :mod:`offt_tpu.kernels.dft` (float64-generated).
Non-smooth N (prime factor > 128) falls back to Bluestein's chirp-z built on
the same machinery.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from . import dft

# Precision of the DFT matmuls. "highest" keeps float32 operands (fp32
# outside the GPU's tensor cores), the only tier that meets the 1e-6
# accuracy bar; "default" lets XLA use TF32 (about 1e-3 relative error).
# Every dot in this module goes through _einsum so none escapes it.
_PRECISION = "highest"


def set_matmul_precision(p: str) -> None:
    """Set the module-default DFT matmul precision: 'default' | 'high' |
    'highest'. Per-plan overrides flow through ``fft_1d(precision=...)``
    (PlanParams.precision)."""
    global _PRECISION
    _PRECISION = p


def _einsum(subscripts, *ops, precision=None):
    return jnp.einsum(subscripts, *ops,
                      precision=precision or _PRECISION)


def _as_complex_dtype(dtype) -> jnp.dtype:
    dtype = jnp.dtype(dtype)
    if dtype in (jnp.complex64, jnp.complex128):
        return dtype
    if dtype == jnp.float64:
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)


def _apply_dft(x: jax.Array, n: int, inverse: bool,
               precision=None) -> jax.Array:
    """Dense DFT along the second-to-last axis of x shaped (..., n, m)."""
    f = jnp.asarray(dft.dft_matrix(n, x.dtype, inverse))
    # (..., n, m) contracted with (k, n) -> (..., k, m): one batched matmul.
    return _einsum("kn,...nm->...km", f, x, precision=precision)


def _fft_last(x: jax.Array, radices: tuple[int, ...], inverse: bool,
              precision=None) -> jax.Array:
    """FFT along the last axis; len(x[-1]) == prod(radices). No 1/N scaling."""
    n = x.shape[-1]
    if n == 1:
        return x
    if len(radices) == 1:
        f = jnp.asarray(dft.dft_matrix(n, x.dtype, inverse))
        return _einsum("kn,...n->...k", f, x, precision=precision)
    r, rest = radices[0], radices[1:]
    m = n // r
    x = x.reshape(x.shape[:-1] + (r, m))
    y = _apply_dft(x, r, inverse, precision=precision)
    tw = jnp.asarray(dft.twiddles(r, m, x.dtype, inverse))
    y = y * tw
    z = _fft_last(y, rest, inverse, precision=precision)
    z = jnp.swapaxes(z, -1, -2)              # (..., m, r): X[k2*r + k1]
    return z.reshape(z.shape[:-2] + (n,))


@functools.lru_cache(maxsize=None)
def _bluestein_tables(n: int, dtype_name: str, inverse: bool):
    """Chirp tables + padded chirp spectrum for Bluestein's algorithm."""
    dtype = np.dtype(dtype_name)
    m = 1
    while m < 2 * n - 1:
        m *= 2
    k = np.arange(n, dtype=np.float64)
    # chirp a_k = exp(-+ i pi k^2 / n); reduce k^2 mod 2n for accuracy
    k2 = np.mod(k * k, 2.0 * n)
    ang = math.pi * k2 / n
    sign = 1.0 if inverse else -1.0
    a = np.cos(ang) + sign * 1j * np.sin(ang)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(a)
    b[m - n + 1:] = np.conj(a[1:][::-1])
    # spectrum of b via our own machinery is circular; use numpy's float64 FFT
    # only to build the *constant table* (never in the runtime path).
    bf = np.fft.fft(b)
    return a.astype(dtype), bf.astype(dtype), m


def _bluestein_last(x: jax.Array, inverse: bool, precision=None) -> jax.Array:
    """Arbitrary-length FFT along the last axis via chirp-z (Bluestein)."""
    n = x.shape[-1]
    a, bf, m = _bluestein_tables(n, str(x.dtype), inverse)
    a = jnp.asarray(a)
    bf = jnp.asarray(bf)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    xa = jnp.pad(x * a, pad)
    rad = dft.factorize(m)
    xf = _fft_last(xa, rad, inverse=False, precision=precision)
    yf = xf * bf
    y = _fft_last(yf, rad, inverse=True, precision=precision) / m
    return y[..., :n] * a


def fft_1d(
    x: jax.Array,
    axis: int = -1,
    inverse: bool = False,
    radices: tuple[int, ...] | None = None,
    precision: str | None = None,
) -> jax.Array:
    """1-D FFT along ``axis`` (complex in, complex out, numpy convention).

    Forward matches ``np.fft.fft``; inverse matches ``np.fft.ifft`` (scaled
    by 1/N). ``radices`` overrides the stage factorization (a tuning knob).
    ``precision`` overrides the precision of the DFT contractions
    ('default' | 'high' | 'highest'); None keeps the module default.
    """
    x = jnp.asarray(x)
    x = x.astype(_as_complex_dtype(x.dtype))
    axis = axis % x.ndim
    n = x.shape[axis]
    if axis != x.ndim - 1:
        x = jnp.moveaxis(x, axis, -1)
    if radices is not None:
        rad = dft.validate_factorization(n, radices)
    else:
        rad = dft.factorize(n)
    if all(r <= dft.MAX_RADIX for r in rad):
        out = _fft_last(x, rad, inverse, precision=precision)
    else:
        out = _bluestein_last(x, inverse, precision=precision)
    if inverse:
        out = out / n
    if axis != x.ndim - 1:
        out = jnp.moveaxis(out, -1, axis)
    return out


def fft(x: jax.Array, axis: int = -1, radices=None) -> jax.Array:
    return fft_1d(x, axis=axis, inverse=False, radices=radices)


def ifft(x: jax.Array, axis: int = -1, radices=None) -> jax.Array:
    return fft_1d(x, axis=axis, inverse=True, radices=radices)
