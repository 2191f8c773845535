"""CPU-mesh wall-clock sweep of the exchange knobs (s ring, w window,
v gather, t chunks) — the receipt VERDICT r3 asked for: does any
non-default exchange knob ever WIN on the virtual CPU mesh?

The reference validates its W/T machinery by wall-clock on real clusters
(offt-compute.c:3501-3680, job-test.sh:9-13). Real multi-chip ICI is not
available in this environment; the CPU-measurable remainder is this grid:
XLA:CPU implements all_to_all/ppermute/all_gather with real buffer
copies and its async scheduler runs the same HLO structure, so relative
knob effects that depend on SCHEDULING (chunking, windows, collective
decomposition) are observable, while effects that depend on
network/compute overlap physics are not.

Run (one process per device count):
    XLA_FLAGS=--xla_force_host_platform_device_count=8  python docs/receipts/run_knob_sweep_cpu.py 8
    XLA_FLAGS=--xla_force_host_platform_device_count=32 python docs/receipts/run_knob_sweep_cpu.py 32

Appends JSONL rows to docs/receipts/knob_sweep_cpu.jsonl.
"""

import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

import offt_tpu  # noqa: E402
from offt_tpu.dist import make_mesh  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "knob_sweep_cpu.jsonl")


def time_plan(p, args, reps=5):
    y = p(args)
    jax.block_until_ready(y)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        y = p(args)
        jax.block_until_ready(y)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ndev = int(sys.argv[1]) if len(sys.argv) > 1 else len(jax.devices())
    assert len(jax.devices()) >= ndev, "set xla_force_host_platform_device_count"
    rows = []
    # exchange-heavy shapes: modest per-axis lengths (cheap local FFTs)
    # with large cross sections (big all_to_all payloads)
    shapes = [(32, 64, 256), (16, 128, 512)]
    meshes = {8: [(2, 4)], 16: [(4, 4)], 32: [(4, 8)]}[ndev]
    for (p1, p2), shape in itertools.product(meshes, shapes):
        mesh = make_mesh(p1, p2)
        base = offt_tpu.plan(shape, "complex64", mesh=mesh).params
        base = base.replace(engine="matmul")   # the sweep's local FFTs
        x = (np.random.default_rng(0).standard_normal(shape)
             + 1j * np.random.default_rng(1).standard_normal(shape)
             ).astype(np.complex64)
        configs = []
        for t in (1, 2, 4):
            for w in range(0, t + 1):
                configs.append(dict(t1=t, t2=t, w1=w, w2=w, s1=0, s2=0, v=0))
        for s in (1,):
            for t in (1, 4):
                configs.append(dict(t1=t, t2=t, w1=0, w2=0, s1=s, s2=s, v=0))
        for v in (1, 2, 3):
            configs.append(dict(t1=1, t2=1, w1=0, w2=0, s1=0, s2=0, v=v))
        for cfg in configs:
            params = base.replace(**cfg)
            try:
                p = offt_tpu.plan(shape, "complex64", mesh=mesh,
                                  params=params)
                ms = time_plan(p, x) * 1e3
            except ValueError as e:     # infeasible point
                ms = None
            row = {"ndev": ndev, "mesh": [p1, p2], "shape": list(shape),
                   **cfg, "ms": round(ms, 3) if ms else None}
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(OUT, "a") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    # per-(mesh, shape) winner summary
    for key in sorted({(tuple(r["mesh"]), tuple(r["shape"])) for r in rows}):
        grp = [r for r in rows if (tuple(r["mesh"]), tuple(r["shape"])) == key
               and r["ms"]]
        best = min(grp, key=lambda r: r["ms"])
        dflt = [r for r in grp if (r["t1"], r["w1"], r["s1"], r["v"])
                == (1, 0, 0, 0)][0]
        print(f"# mesh {key[0]} shape {key[1]}: best "
              f"t={best['t1']} w={best['w1']} s={best['s1']} v={best['v']} "
              f"{best['ms']} ms vs t1/w0/s0/v0 {dflt['ms']} ms "
              f"({dflt['ms'] / best['ms']:.2f}x)", flush=True)


if __name__ == "__main__":
    main()
