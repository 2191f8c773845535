"""Headline benchmark: single-card 3-D c2c FFT throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
``vs_baseline`` is our speed relative to XLA's built-in FFT
(jnp.fft.fftn) on the same card and shape (>1 means offt is faster) —
the stand-in for the reference's FFTW-MPI comparison baseline
(run-fft.c -a 1). The line also names the device it ran on.

Timing: obs/profile.py:time_fn — warm-up calls (compilation), then the
median of OFFT_BENCH_REPS calls, each ending in block_until_ready.

FLOP convention: 5 * n * log2(n) with n = total complex points (HPC
Challenge / FFTW convention), independent of the algorithm actually used.

Exits non-zero, printing no result, when JAX finds no GPU.
"""

import json
import math
import os
import sys


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench.py: needs a GPU, JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1

    import offt_tpu
    from offt_tpu.obs.profile import time_fn
    from offt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n = int(os.environ.get("OFFT_BENCH_N", "256"))
    reps = int(os.environ.get("OFFT_BENCH_REPS", "20"))
    shape = (n, n, n)
    total = n ** 3
    flops = 5.0 * total * math.log2(total)

    rng = np.random.default_rng(0)
    re = jax.device_put(rng.standard_normal(shape).astype(np.float32))
    im = jax.device_put(rng.standard_normal(shape).astype(np.float32))

    # use_cache=True: a tuned plan for this shape and device kind, if any
    p = offt_tpu.plan(shape, "complex64", planar=True, use_cache=True)
    ours = time_fn(p._fn, (re, im), reps=reps)

    @jax.jit
    def xla_fft(r, i):
        y = jnp.fft.fftn(jax.lax.complex(r, i))
        return jnp.real(y), jnp.imag(y)

    xla = time_fn(xla_fft, (re, im), reps=reps)
    dev = jax.devices()
    print(json.dumps({
        "metric": f"3dfft_{n}^3_c2c_single_card",
        "value": flops / ours.median / 1e9,
        "unit": "GFLOP/s",
        "vs_baseline": xla.median / ours.median,
        "t_ms": ours.median * 1e3,
        "spread": ours.spread,
        "xla_t_ms": xla.median * 1e3,
        "engine": p.params.engine,
        "device": {"platform": dev[0].platform, "kind": dev[0].device_kind,
                   "count": len(dev)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
