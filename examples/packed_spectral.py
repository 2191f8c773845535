"""Spectral filtering in the packed-Nyquist layout (single device).

The packed half-spectrum (`plan(..., packed=True)`, kernels/rfft.py) keeps
the frequency axis at exactly M = Nz/2 bins: plane 0 carries
`X_0 + i*X_M`. A spectral pipeline r2c -> multiply -> c2r never needs the
numpy (..., M+1) layout; the only care point is plane 0, where the two
packed planes need *different* filter values g(.,.,0) and g(.,.,M):

    A = (P + conj(P[-kx,-ky])) / 2        # = spectrum plane k=0
    B = (P - conj(P[-kx,-ky])) / 2i       # = spectrum plane k=M
    P' = g0 * A + i * gM * B              # re-packed, filtered plane 0

Everything is one jitted function; planes 1..M-1 multiply pointwise.

Run:  python examples/packed_spectral.py          (virtual CPU)
      OFFT_EXAMPLE_REAL=1 python examples/...     (on the GPU)
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import os

import jax

if not os.environ.get("OFFT_EXAMPLE_REAL"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import offt_tpu


def main():
    n = 256
    nx = ny = 8 if jax.default_backend() == "cpu" else n
    shape = (nx, ny, n)
    m = n // 2

    fwd = offt_tpu.plan(shape, "complex64", real=True, planar=True,
                        packed=True)
    inv = offt_tpu.plan(shape, "complex64", real=True, inverse=True,
                        planar=True, packed=True)

    # low-pass filter g(k) = exp(-|k|^2 / (2 sigma^2)), integer modes
    kx = np.fft.fftfreq(nx) * nx
    ky = np.fft.fftfreq(ny) * ny
    kz = np.arange(m + 1)  # rfft modes 0..M
    g = np.exp(-(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                 + kz[None, None, :] ** 2) / (2 * 12.0 ** 2)).astype(np.float32)
    g_body = jnp.asarray(g[..., 1:m])        # planes 1..M-1
    g0 = jnp.asarray(g[..., 0])
    gm = jnp.asarray(g[..., m])

    @jax.jit
    def lowpass(x):
        pr, pi = fwd._fn(x)
        # planes 1..M-1: pointwise
        fr = pr.at[..., 1:].multiply(g_body)
        fi = pi.at[..., 1:].multiply(g_body)
        # plane 0: unpack -> filter with g0/gM -> repack
        p = jax.lax.complex(pr[..., 0], pi[..., 0])
        rev = jnp.conj(jnp.roll(jnp.flip(p, axis=(-2, -1)), shift=(1, 1),
                                axis=(-2, -1)))
        a = 0.5 * (p + rev)
        b = -0.5j * (p - rev)
        pp = g0 * a + 1j * (gm * b)
        fr = fr.at[..., 0].set(jnp.real(pp))
        fi = fi.at[..., 0].set(jnp.imag(pp))
        return inv._fn(fr, fi)

    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    got = np.asarray(lowpass(x))

    want = np.fft.irfftn(np.fft.rfftn(x.astype(np.float64)) * g, s=shape,
                         axes=(0, 1, 2))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"packed spectral low-pass: shape={shape} rel_err={err:.3e}")
    assert err < 1e-5
    print("OK — the half-spectrum never left the packed layout")


if __name__ == "__main__":
    main()
