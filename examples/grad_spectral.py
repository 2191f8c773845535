"""Gradient-based spectral deconvolution — differentiable plans demo.

A blurred, noisy observation  y = irfft3(H * rfft3(s_true)) + noise  is
inverted by gradient descent on  L(s) = ||blur(s) - y||^2 + lam*||s||^2,
differentiating END-TO-END through the r2c and c2r plans with jax.grad
(native autodiff: the plans are plain JAX), so the whole optimization is
jit-compiled device code.

The MPI/C reference has no autodiff analogue — this is the JAX-side
"neural operator / differentiable physics" surface.

Run:  JAX_PLATFORMS=cpu python examples/grad_spectral.py
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

    # Gaussian low-pass transfer function (real, symmetric -> the
    # filtered spectrum stays Hermitian-consistent)
    k = [np.fft.fftfreq(n), np.fft.fftfreq(n), np.fft.rfftfreq(n)]
    k2 = (k[0][:, None, None] ** 2 + k[1][None, :, None] ** 2
          + k[2][None, None, :] ** 2)
    h = jnp.asarray(np.exp(-k2 / (2 * 0.25 ** 2)).astype(np.float32))

    def blur(s):
        yr, yi = fwd(s)
        return inv((yr * h, yi * h))

    # smooth (band-limited) source so the blur is invertible in practice
    s_true = blur(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32))) * 4.0
    y_obs = blur(s_true) + 0.001 * jnp.asarray(
        rng.standard_normal(shape).astype(np.float32))

    lam = 1e-5

    @jax.jit
    def loss(s):
        r = blur(s) - y_obs
        return jnp.sum(r * r) + lam * jnp.sum(s * s)

    grad = jax.jit(jax.grad(loss))
    s = jnp.zeros(shape, jnp.float32)
    lr = 0.45
    l0 = float(loss(s))
    for _ in range(150):
        s = s - lr * grad(s)
    l1 = float(loss(s))
    err = float(jnp.linalg.norm(s - s_true) / jnp.linalg.norm(s_true))
    print(f"loss {l0:.2f} -> {l1:.5f}; recovered rel err {err:.3f}")
    assert l1 < 0.01 * l0 and err < 0.25
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
