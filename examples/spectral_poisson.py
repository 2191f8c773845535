"""Spectral Poisson solver on a distributed mesh — the "spectral solvers"
use case of BASELINE config 5.

Solves  lap(u) = f  with periodic BCs by dividing by -|k|^2 in frequency
space, using a forward r2c plan and an inverse c2r plan. The whole solve
is one jitted function; the division happens in the transposed-out layout
(no extra resharding between forward and inverse).

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      JAX_PLATFORMS=cpu python examples/spectral_poisson.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

# demo runs on virtual CPU devices; set OFFT_EXAMPLE_REAL=1 for the GPUs
if not os.environ.get("OFFT_EXAMPLE_REAL"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import offt_tpu
from offt_tpu.dist import make_mesh


def main():
    n = 32
    ndev = len(jax.devices())
    p1 = int(np.sqrt(ndev))
    while ndev % p1:
        p1 -= 1
    mesh = make_mesh(p1, ndev // p1)

    fwd = offt_tpu.plan((n, n, n), "complex64", mesh=mesh, real=True)
    inv = offt_tpu.plan((n, n, n), "complex64", mesh=mesh, real=True,
                        inverse=True)

    kx = np.fft.fftfreq(n) * 2 * np.pi * n / (2 * np.pi)  # integer modes
    kz = np.fft.rfftfreq(n) * n
    k2 = (kx[:, None, None] ** 2 + kx[None, :, None] ** 2
          + kz[None, None, :] ** 2).astype(np.float32)
    inv_k2 = np.where(k2 > 0, -1.0 / np.maximum(k2, 1e-30), 0.0)

    def solve(f):
        fh = fwd._fn(f)
        uh = fh * jnp.asarray(inv_k2)
        return inv._fn(uh)

    solve_j = jax.jit(solve)

    # manufactured solution: u = sin(2 pi x / n) * cos(4 pi y / n)
    i = np.arange(n)
    u_true = (np.sin(2 * np.pi * i / n)[:, None, None]
              * np.cos(4 * np.pi * i / n)[None, :, None]
              * np.ones((1, 1, n))).astype(np.float32)
    lap_scale = -( (2 * np.pi / n * n / (2 * np.pi)) )  # modes 1 and 2
    # f = lap(u) in spectral terms: -(1^2 + 2^2) u = -5 u (integer modes)
    f = (-5.0 * u_true).astype(np.float32)

    u = np.asarray(solve_j(f))
    err = np.linalg.norm(u - u_true) / np.linalg.norm(u_true)
    print(f"Poisson solve rel err: {err:.2e}")
    assert err < 1e-5


if __name__ == "__main__":
    main()
