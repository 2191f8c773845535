"""Real-input (r2c) and real-output (c2r) 1-D transforms.

The reference gets r2c from FFTW's ``fftw_plan_many_dft_r2c`` along z
(offt-compute.c setup_p1d, is_r2c paths; the Nz/2+1 frequency fold appears
throughout, e.g. offt-compute.c:63). The XLA-FFT engine calls
``jnp.fft.rfft``/``irfft`` directly; the matmul engine uses the classic
even/odd packing here: a length-N real FFT = one length-N/2 complex FFT
(the mixed-radix matmul chain) + an O(N) untangle pass that XLA fuses.

The packed half-spectrum layout (``plan(real=True, packed=True)``) keeps
M = N/2 bins along the last axis: bin 0 carries ``X[0] + i*X[M]`` (the DC
and Nyquist planes, each Hermitian in the other axes), bins 1..M-1 are
the numpy bins. :func:`pack_rfft3d` / :func:`unpack_rfft3d` convert
between it and the numpy ``(..., M+1)`` layout.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .stockham import _as_complex_dtype, fft_1d


def _real_dtype(cdtype) -> jnp.dtype:
    return jnp.dtype(jnp.float64 if jnp.dtype(cdtype) == jnp.complex128 else jnp.float32)


@functools.lru_cache(maxsize=None)
def _half_twiddles(n: int, dtype_name: str, inverse: bool) -> np.ndarray:
    """W^k = exp(-+2i pi k / N) for k = 0..N/2 (float64-generated)."""
    m = n // 2
    k = np.arange(m + 1, dtype=np.float64)
    ang = 2.0 * math.pi * k / n
    w = np.cos(ang) + (1j if inverse else -1j) * np.sin(ang)
    return w.astype(np.dtype(dtype_name))


def rfft_1d(x: jax.Array, axis: int = -1, radices=None,
            fft_fn=None) -> jax.Array:
    """Forward r2c along ``axis``: real (..., N) -> complex (..., N//2+1).

    Matches ``np.fft.rfft``. Even N uses the packed half-length transform;
    odd N falls back to a full c2c and slices the non-negative bins.
    ``fft_fn(v, axis, inverse)`` overrides the inner c2c.
    """
    x = jnp.asarray(x)
    axis = axis % x.ndim
    n = x.shape[axis]
    cdtype = _as_complex_dtype(x.dtype)
    do_fft = fft_fn or (lambda v, ax, inv: fft_1d(v, axis=ax, inverse=inv,
                                                  radices=radices))
    if n % 2 != 0 or n < 2:
        full = do_fft(x.astype(cdtype), axis, False)
        return jax.lax.slice_in_dim(full, 0, n // 2 + 1, axis=axis)
    x = jnp.moveaxis(x, axis, -1)
    m = n // 2
    v = x[..., 0::2].astype(cdtype) + 1j * x[..., 1::2].astype(cdtype)
    vf = do_fft(v, -1, False)
    # V[(M - k) mod M], k = 0..M  (two wrap-around entries)
    vr = jnp.concatenate(
        [vf[..., :1], vf[..., :0:-1], vf[..., :1]], axis=-1
    )  # length M+1
    vf1 = jnp.concatenate([vf, vf[..., :1]], axis=-1)  # V[k], k = 0..M
    xe = 0.5 * (vf1 + jnp.conj(vr))
    xo = -0.5j * (vf1 - jnp.conj(vr))
    w = jnp.asarray(_half_twiddles(n, str(cdtype), inverse=False))
    out = xe + w * xo
    return jnp.moveaxis(out, -1, axis)


def irfft_1d(x: jax.Array, n: int | None = None, axis: int = -1,
             radices=None, fft_fn=None) -> jax.Array:
    """Inverse c2r along ``axis``: complex (..., N//2+1) -> real (..., N).

    Matches ``np.fft.irfft`` (assumes conjugate symmetry of the implied full
    spectrum; scales by 1/N). ``fft_fn`` as in :func:`rfft_1d`.
    """
    x = jnp.asarray(x)
    axis = axis % x.ndim
    nf = x.shape[axis]
    n = n if n is not None else 2 * (nf - 1)
    cdtype = _as_complex_dtype(x.dtype)
    rdtype = _real_dtype(cdtype)
    do_fft = fft_fn or (lambda v, ax, inv: fft_1d(v, axis=ax, inverse=inv,
                                                  radices=radices))
    if n % 2 != 0 or n < 2:
        # rebuild the full spectrum and do a c2c inverse
        x_m = jnp.moveaxis(x.astype(cdtype), axis, -1)
        tail = jnp.conj(x_m[..., 1 : n - nf + 1][..., ::-1])
        full = jnp.concatenate([x_m[..., :nf], tail], axis=-1)
        out = do_fft(full, -1, True).real.astype(rdtype)
        return jnp.moveaxis(out, -1, axis)
    if nf != n // 2 + 1:
        raise ValueError(f"expected {n // 2 + 1} frequency bins, got {nf}")
    x = jnp.moveaxis(x.astype(cdtype), axis, -1)
    m = n // 2
    xr = x[..., ::-1]  # X[M - k], k = 0..M
    xe = 0.5 * (x + jnp.conj(xr))
    w = jnp.asarray(_half_twiddles(n, str(cdtype), inverse=True))  # conj(W^k)
    xo = 0.5 * (x - jnp.conj(xr)) * w
    v = (xe + 1j * xo)[..., :m]
    vt = do_fft(v, -1, True)
    out = jnp.stack([vt.real, vt.imag], axis=-1).reshape(vt.shape[:-1] + (n,))
    return jnp.moveaxis(out.astype(rdtype), -1, axis)


def pack_last(y):
    """Complex numpy-layout (..., M+1) -> packed (..., M) along the last
    axis: bin 0 := bin 0 + i * bin M."""
    m = y.shape[-1] - 1
    return jnp.concatenate([y[..., :1] + 1j * y[..., m:], y[..., 1:m]],
                           axis=-1)


def unpack_last(p):
    """Packed (..., M) -> complex (..., M+1) along the last axis, for
    spectra whose bin-0 and bin-M entries are real (1-D transforms of
    real data, and the c2r stage once the other axes are inverted):
    bin 0 = Re(p0), bin M = Im(p0)."""
    p0 = p[..., :1]
    zero = jnp.zeros_like(jnp.real(p0))
    return jnp.concatenate([jax.lax.complex(jnp.real(p0), zero), p[..., 1:],
                            jax.lax.complex(jnp.imag(p0), zero)], axis=-1)


def unpack_3d(p):
    """Packed 3-D half-spectrum (..., X, Y, M) -> numpy rfftn layout
    (..., X, Y, M+1). The bin-0 plane P = A + i*B holds the spectra of
    two real planes, each Hermitian in (x, y); they separate as
    A = (P + conj(P[-kx, -ky])) / 2 and B = (P - conj(P[-kx, -ky])) / 2i."""
    p0 = p[..., 0]
    rev = jnp.conj(jnp.roll(jnp.flip(p0, axis=(-2, -1)), shift=(1, 1),
                            axis=(-2, -1)))
    a = 0.5 * (p0 + rev)
    b = -0.5j * (p0 - rev)
    return jnp.concatenate([a[..., None], p[..., 1:], b[..., None]],
                           axis=-1)


def pack_rfft3d(yr, yi):
    """Planar numpy-layout half-spectrum (..., M+1) -> the packed planar
    (..., M) form (bin 0 := bin 0 + i * bin M)."""
    y = pack_last(jax.lax.complex(jnp.asarray(yr), jnp.asarray(yi)))
    return jnp.real(y), jnp.imag(y)


def unpack_rfft3d(yr, yi):
    """Planar packed 3-D half-spectrum (..., X, Y, M) -> the numpy rfftn
    layout (..., X, Y, M+1), as a planar pair."""
    y = unpack_3d(jax.lax.complex(jnp.asarray(yr), jnp.asarray(yi)))
    return jnp.real(y), jnp.imag(y)
