"""A/B of the two local engines through ``plan()`` on the GPU.

    python -m offt_tpu.bench.engine_ab [--out FILE.jsonl]

For each transform of the table below, times the XLA-FFT engine (cuFFT)
and the matmul chain (``precision="highest"``) in turns, A B A B, each
turn the median of 10 calls after warm-up (obs/profile.py:time_fn), and
reports both medians, their spread, the difference of the matmul output
from the XLA output, and the device-memory floor: one read of the input
plus one write of the output at the card's published bandwidth
(bench/roofline.py). Then the matmul engine's precision tiers at 256^3.
Prints one JSON line per row (and appends them to ``--out``). Exits
non-zero where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

# (label, plan shape, batch, real, inverse, dtype)
CASES = (
    ("c2c 256^3 fwd", (256, 256, 256), 0, False, False, "complex64"),
    ("c2c 256^3 inv", (256, 256, 256), 0, False, True, "complex64"),
    ("c2c 512^3 fwd", (512, 512, 512), 0, False, False, "complex64"),
    ("c2c 512^3 inv", (512, 512, 512), 0, False, True, "complex64"),
    ("r2c 512^3", (512, 512, 512), 0, True, False, "complex64"),
    ("c2r 512^3", (512, 512, 512), 0, True, True, "complex64"),
    ("c2c 2-D 64x1024^2 fwd", (1, 1024, 1024), 64, False, False,
     "complex64"),
    ("c2c 1-D 2^24 fwd", (1, 1, 1 << 24), 0, False, False, "complex64"),
    ("c2c 256^3 complex128 fwd", (256, 256, 256), 0, False, False,
     "complex128"),
)


def _operand(shape, batch, real, inverse, dtype, rng):
    import jax

    rdt = np.float64 if dtype == "complex128" else np.float32
    full = ((batch,) if batch else ()) + tuple(shape)
    x = jax.device_put(rng.standard_normal(full, dtype=rdt))
    if real and inverse:
        # a Hermitian-consistent half spectrum: the spectrum of real data
        return jax.numpy.fft.rfftn(x, axes=(-3, -2, -1))
    if not real:
        x = x + 1j * jax.device_put(rng.standard_normal(full, dtype=rdt))
    return x


def _bytes(shape, batch, real, dtype):
    n = math.prod(shape) * max(batch, 1)
    c = 16 if dtype == "complex128" else 8
    if not real:
        return 2 * n * c
    half = n // shape[-1] * (shape[-1] // 2 + 1)
    return n * c // 2 + half * c


def _rel(a, b) -> float:
    import jax.numpy as jnp

    a = jnp.asarray(a)
    b = jnp.asarray(b)
    d = jnp.sum(jnp.abs(a - b).astype(jnp.float64) ** 2)
    r = jnp.sum(jnp.abs(b).astype(jnp.float64) ** 2)
    return float(jnp.sqrt(d / r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="engine_ab")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print("engine_ab: needs a GPU", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)

    import offt_tpu
    from offt_tpu.bench.roofline import device_spec
    from offt_tpu.obs.profile import time_fn
    from offt_tpu.plan.params import PlanParams
    from offt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kind = jax.devices()[0].device_kind
    hbm = device_spec(kind).hbm_gbps * 1e9
    rows = []

    def emit(row):
        row["device_kind"] = kind
        rows.append(row)
        print(json.dumps(row), flush=True)

    rng = np.random.default_rng(0)
    for label, shape, batch, real, inverse, dtype in CASES:
        x = _operand(shape, batch, real, inverse, dtype, rng)
        plans = {e: offt_tpu.plan(shape, dtype, real=real, inverse=inverse,
                                  batch_dims=1 if batch else 0,
                                  params=PlanParams(engine=e),
                                  use_cache=False)
                 for e in ("xla", "matmul")}
        times = {e: [] for e in plans}
        for _ in range(2):          # A B A B
            for e, p in plans.items():
                times[e].extend(time_fn(p._fn, (x,)).times)
        diff = _rel(plans["matmul"](x), plans["xla"](x))
        floor = _bytes(shape, batch, real, dtype) / hbm
        med = {e: float(np.median(t)) for e, t in times.items()}
        emit({"case": label, "floor_ms": floor * 1e3,
              **{f"{e}_ms": med[e] * 1e3 for e in med},
              **{f"{e}_spread": (max(t) - min(t)) / med[e]
                 for e, t in times.items()},
              "calls": len(times["xla"]),
              "matmul_over_xla": med["matmul"] / med["xla"],
              "matmul_vs_xla_rel_l2": diff})
        del x, plans

    shape = (256, 256, 256)
    x = _operand(shape, 0, False, False, "complex64", rng)
    ref = offt_tpu.plan(shape, "complex64", params=PlanParams())(x)
    for prec in ("highest", "high", "default"):
        p = offt_tpu.plan(shape, "complex64", use_cache=False,
                          params=PlanParams(engine="matmul", precision=prec))
        t = time_fn(p._fn, (x,))
        emit({"case": f"matmul tier {prec} c2c 256^3 fwd",
              "ms": t.median * 1e3, "spread": t.spread,
              "rel_l2_vs_xla": _rel(p(x), ref)})
    if ns.out:
        with open(ns.out, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
