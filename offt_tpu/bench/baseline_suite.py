"""BASELINE.json config suite: run every target configuration and emit one
JSONL record per config (median time over 10 calls, rel. error vs numpy).

Configs (BASELINE.json), with the sizes this suite runs:
1. 1D c2c N=2^20 fp32 — accuracy vs numpy (1e-6) + throughput
2. 3D c2c 256^3 single-device
3. 3D c2c pencil over every visible device (256^3 here)
4. 3D r2c (stated 1024^3; run at 512^3)
5. Batched 3D c2c (stated 64x256^3; run at 8x128^3)

Run: python -m offt_tpu.bench.baseline_suite [--fast]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from ..obs.profile import time_fn


def _emit(rec):
    print(json.dumps(rec), flush=True)


def config1_1d(fast: bool):
    import jax

    import offt_tpu

    n = 1 << (18 if fast else 20)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    import jax.numpy as jnp

    re = jax.device_put(x.real.copy())
    im = jax.device_put(x.imag.copy())

    @jax.jit
    def f2(r, i):
        y = offt_tpu.fft.fft(jax.lax.complex(r, i))
        return jnp.real(y), jnp.imag(y)

    gr, gi = f2(re, im)
    got = np.asarray(gr) + 1j * np.asarray(gi)
    want = np.fft.fft(x)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    t = time_fn(f2, (re, im)).median
    _emit({"config": 1, "desc": f"1D c2c N=2^{n.bit_length()-1} fp32",
           "rel_err": float(err), "pass": bool(err < 1e-6),
           "t_ms": round(t * 1e3, 3)})


def _fft3d_planar_case(config, desc, shape, batch=0, mesh=None, real=False,
                       tol=1e-6, params=None):
    import jax

    import offt_tpu

    full = ((batch,) if batch else ()) + shape
    rng = np.random.default_rng(0)
    re = jax.device_put(rng.standard_normal(full).astype(np.float32))
    p = offt_tpu.plan(shape, "complex64", mesh=mesh, real=real, planar=True,
                      batch_dims=1 if batch else 0, params=params)
    if real:
        args = (re,)
    else:
        im = jax.device_put(rng.standard_normal(full).astype(np.float32))
        args = (re, im)
    out = p._fn(*args)
    got = np.asarray(out[0]) + 1j * np.asarray(out[1])
    axes = (-3, -2, -1)
    if real:
        want = np.fft.rfftn(np.asarray(re), axes=axes)
    else:
        want = np.fft.fftn(np.asarray(re) + 1j * np.asarray(im), axes=axes)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    t = time_fn(p._fn, args).median
    total = math.prod(shape) * max(batch, 1)
    gflops = 5.0 * total * math.log2(math.prod(shape)) / t / 1e9
    _emit({"config": config, "desc": desc, "rel_err": float(err),
           "pass": bool(err < tol), "t_ms": round(t * 1e3, 3),
           "gflops": round(gflops, 1)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller sizes (CI-friendly)")
    ns = ap.parse_args(argv)
    import jax

    from offt_tpu.dist import make_mesh
    from offt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    fast = ns.fast
    config1_1d(fast)
    n2 = 64 if fast else 256
    _fft3d_planar_case(2, f"3D c2c {n2}^3 single-device", (n2,) * 3)
    # config 3: pencil over all available devices
    nd = len(jax.devices())
    if nd > 1:
        p1 = int(math.isqrt(nd))
        while nd % p1:
            p1 -= 1
        mesh = make_mesh(p1, nd // p1)
        n3 = 32 if fast else 256
        _fft3d_planar_case(3, f"3D c2c {n3}^3 pencil {p1}x{nd//p1}",
                           (n3,) * 3, mesh=mesh, tol=1e-5)
    else:
        _emit({"config": 3, "desc": "pencil (needs >1 device)",
               "skipped": True})
    n4 = 64 if fast else 512
    _fft3d_planar_case(4, f"3D r2c {n4}^3", (n4,) * 3, real=True)
    nb, n5 = (2, 32) if fast else (8, 128)
    _fft3d_planar_case(5, f"batched {nb}x{n5}^3 c2c", (n5,) * 3, batch=nb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
