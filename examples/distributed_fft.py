"""Distributed pencil FFT demo on a virtual CPU mesh (no GPUs needed).

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      JAX_PLATFORMS=cpu python examples/distributed_fft.py
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

import numpy as np

import offt_tpu
from offt_tpu.dist import make_mesh
from offt_tpu.plan.params import PlanParams


def main():
    n = len(jax.devices())
    p1 = int(np.sqrt(n))
    while n % p1:
        p1 -= 1
    mesh = make_mesh(p1, n // p1)
    print(f"mesh: {dict(mesh.shape)} on {jax.default_backend()}")

    shape = (32, 32, 32)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)

    params = PlanParams(p1=p1, t1=2, t2=2, ry=5)
    plan = offt_tpu.plan(shape, "complex64", mesh=mesh, params=params)
    y = plan(x)
    print("output sharding:", y.sharding.spec)

    err = (np.linalg.norm(np.asarray(y) - np.fft.fftn(x))
           / np.linalg.norm(np.fft.fftn(x)))
    print(f"rel err vs numpy: {err:.2e}")

    inv = offt_tpu.plan(shape, "complex64", mesh=mesh, params=params,
                        inverse=True)
    rt = inv(y)
    print(f"roundtrip err: "
          f"{np.linalg.norm(np.asarray(rt) - x) / np.linalg.norm(x):.2e}")


if __name__ == "__main__":
    main()
