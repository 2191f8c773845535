"""CPU-mesh wall-clock sweep of the distributed 1-D engine's knobs
(dist/long1d.py): exchange strategies (s ring / v gather), the (n1, n2)
split, and the single-device four-step as the no-collective baseline.

Same epistemics as run_knob_sweep_cpu.py: XLA:CPU implements the
collectives with real buffer copies and schedules the same HLO
structure, so SCHEDULING-dependent knob effects are observable while
network-physics ones are not. The receipt answers (a) does every knob
combination compute the same spectrum, (b) which exchange strategy wins
on the virtual mesh, (c) how the distributed engine's wall compares to
one device doing the whole transform (CPU "devices" share the host's
cores, so this is a correctness-structure receipt, not a speedup claim).

Run:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python docs/receipts/run_dist1d_cpu.py 8

Appends JSONL rows to docs/receipts/dist1d_cpu.jsonl.
"""

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
from offt_tpu.plan.params import PlanParams  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "dist1d_cpu.jsonl")


def time_plan(p, x, reps=7):
    y = p(x)
    jax.block_until_ready(y)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        y = p(x)
        jax.block_until_ready(y)
        ts.append(time.perf_counter() - t0)
    return min(ts), y


def main(ndev: int):
    p1 = int(np.sqrt(ndev))
    while ndev % p1:
        p1 -= 1
    mesh = make_mesh(p1, ndev // p1)
    n = 1 << 20
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64).reshape(1, 1, n)
    want = np.fft.fft(x[0, 0])
    base = PlanParams()

    rows = []
    cases = [
        ("default_a2a", base, mesh),
        ("ring_s", base.replace(s1=1, s2=1), mesh),
        ("gather_v", base.replace(v=3), mesh),
        ("split_2048x512", base.replace(split_1d=(2048, 512)), mesh),
        ("split_512x2048", base.replace(split_1d=(512, 2048)), mesh),
        ("matmul_local", base.replace(engine="matmul"), mesh),
        ("single_device", base, None),
    ]
    for name, pp, m in cases:
        p = offt_tpu.plan((1, 1, n), "complex64", mesh=m, params=pp)
        t, y = time_plan(p, x)
        got = np.asarray(y)[0, 0]
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        row = {"step": "dist1d", "case": name, "ndev": ndev if m else 1,
               "n": n, "t_ms": round(t * 1e3, 3), "rel_err": err,
               "routed_dist": p._shards is not None}
        rows.append(row)
        print(json.dumps(row), flush=True)
        assert err < 1e-6, (name, err)
    with open(OUT, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
