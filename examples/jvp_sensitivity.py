"""Forward-mode sensitivity through plans — the jvp demo.

A spectral diffusion solve  u(t) = irfft3( exp(-nu * |k|^2 * t) * rfft3(u0) )
is differentiated with jax.jacfwd w.r.t. a FEW physical parameters
(nu, t): forward mode costs one jvp pass per parameter regardless of the
output's size (here a whole 3-D field), where reverse mode would need
one vjp per output element. Plans support both modes (native autodiff:
the jvp of the linear FFT is the FFT itself); the parameter dependence
lives in the transfer function between the plans.

Self-verifies ∂u/∂nu and ∂u/∂t against central finite differences.

Run:  JAX_PLATFORMS=cpu python examples/jvp_sensitivity.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import os

if not os.environ.get("OFFT_EXAMPLE_REAL"):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

if not os.environ.get("OFFT_EXAMPLE_REAL"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import offt_tpu


def main():
    n = 32
    shape = (n, n, n)
    rng = np.random.default_rng(0)

    fwd = offt_tpu.plan(shape, "complex64", real=True, planar=True)
    inv = offt_tpu.plan(shape, "complex64", real=True, inverse=True,
                        planar=True)

    k = [np.fft.fftfreq(n) * 2 * np.pi, np.fft.fftfreq(n) * 2 * np.pi,
         np.fft.rfftfreq(n) * 2 * np.pi]
    k2 = jnp.asarray((k[0][:, None, None] ** 2 + k[1][None, :, None] ** 2
                      + k[2][None, None, :] ** 2).astype(np.float32))
    u0 = jnp.asarray(rng.standard_normal(shape).astype(np.float32))

    @jax.jit
    def solve(params):
        nu, t = params
        g = jnp.exp(-nu * k2 * t)          # heat kernel in frequency space
        yr, yi = fwd(u0)
        return inv((yr * g, yi * g))

    theta = jnp.asarray([0.05, 1.5], jnp.float32)

    # forward mode: 2 jvp passes for the full (32^3,) x 2 Jacobian slab
    jac = jax.jacfwd(solve)(theta)         # shape (n, n, n, 2)
    du_dnu, du_dt = jac[..., 0], jac[..., 1]

    # finite-difference verification
    eps = 1e-3
    fd_nu = (solve(theta + jnp.asarray([eps, 0.0]))
             - solve(theta - jnp.asarray([eps, 0.0]))) / (2 * eps)
    fd_t = (solve(theta + jnp.asarray([0.0, eps]))
            - solve(theta - jnp.asarray([0.0, eps]))) / (2 * eps)

    r1 = float(jnp.linalg.norm(du_dnu - fd_nu) / jnp.linalg.norm(fd_nu))
    r2 = float(jnp.linalg.norm(du_dt - fd_t) / jnp.linalg.norm(fd_t))
    print(f"d u/d nu: jacfwd vs FD rel err {r1:.2e}")
    print(f"d u/d t : jacfwd vs FD rel err {r2:.2e}")
    assert r1 < 5e-3 and r2 < 5e-3

    # jvp directly: one pass, one direction
    _, du = jax.jvp(solve, (theta,), (jnp.asarray([1.0, 0.0], jnp.float32),))
    assert float(jnp.linalg.norm(du - du_dnu)
                 / jnp.linalg.norm(du_dnu)) < 1e-5
    print("OK")


if __name__ == "__main__":
    main()
