"""Minimal Fourier Neural Operator layer on differentiable plans.

A spectral-convolution layer (the FNO building block: rfft -> learned
per-mode complex weights on the low modes -> irfft) whose parameters are
trained with jax.grad THROUGH the offt-tpu r2c/c2r plans — native
autodiff makes the whole training step one jit-compiled device
program. Learns a hidden linear operator (a known
spectral multiplier) from input/output pairs; the fit must recover it.

The MPI/C reference has no autodiff analogue; this is the JAX-side
"neural operator / differentiable physics" surface of the framework.

Run:  JAX_PLATFORMS=cpu python examples/fno_layer.py
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
    n = 32          # cube size
    modes = 8       # learned low-frequency modes per axis
    batch = 4
    rng = np.random.default_rng(0)

    fwd = offt_tpu.plan((n, n, n), "complex64", real=True, planar=True,
                        batch_dims=1)
    inv = offt_tpu.plan((n, n, n), "complex64", real=True, inverse=True,
                        planar=True, batch_dims=1)

    def spectral_conv(wr, wi, x):
        """rfft3 -> multiply the (modes, modes, modes) low corner by the
        learned complex weights -> irfft3. Complex-linear in x."""
        yr, yi = fwd(x)
        pad = [(0, n - modes), (0, n - modes), (0, n // 2 + 1 - modes)]
        fr = jnp.pad(wr, pad)
        fi = jnp.pad(wi, pad)
        zr = yr * fr - yi * fi
        zi = yr * fi + yi * fr
        return inv((zr, zi))

    # ground truth: a random spectral multiplier on the same modes
    wr_true = rng.standard_normal((modes,) * 3).astype(np.float32)
    wi_true = rng.standard_normal((modes,) * 3).astype(np.float32)
    x_train = rng.standard_normal((batch, n, n, n)).astype(np.float32)
    y_train = spectral_conv(jnp.asarray(wr_true), jnp.asarray(wi_true),
                            jnp.asarray(x_train))

    @jax.jit
    def loss(wr, wi):
        pred = spectral_conv(wr, wi, jnp.asarray(x_train))
        r = pred - y_train
        return jnp.mean(r * r)

    grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
    wr = jnp.zeros((modes,) * 3, jnp.float32)
    wi = jnp.zeros((modes,) * 3, jnp.float32)
    l0 = float(loss(wr, wi))
    lr = 2e-2 * n ** 3   # spectral-domain params see an N^3-scaled grad
    for i in range(400):
        gr, gi = grad(wr, wi)
        wr = wr - lr * gr
        wi = wi - lr * gi
    l1 = float(loss(wr, wi))
    werr = float(np.linalg.norm(np.asarray(wr) - wr_true)
                 / np.linalg.norm(wr_true))
    print(f"loss {l0:.4f} -> {l1:.3e}; recovered weight rel err {werr:.4f}")
    assert l1 < 1e-4 * l0 and werr < 0.05
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
