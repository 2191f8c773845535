"""Receipt for the shipped distributed defaults (VERDICT r4 #2).

Measures, on the 8-device virtual CPU mesh, the receipted shapes with
(a) the OLD round-4 heuristic (t=min(4,.), w=min(2,t)),
(b) what ``plan(mesh=...)`` now picks with no explicit params (bundled
    mesh-keyed wisdom where present, else the new class heuristic), and
(c) the receipted tuned best point
and asserts (b) lands within noise of (c).

Run:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python docs/receipts/run_dist_defaults.py

Appends JSONL rows to docs/receipts/dist_defaults_cpu.jsonl.
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

OUT = os.path.join(os.path.dirname(__file__), "dist_defaults_cpu.jsonl")


def time_plan(p, args, reps=7):
    y = p(args)
    jax.block_until_ready(y)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        y = p(args)
        jax.block_until_ready(y)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


CASES = [
    # shape, receipted tuned best (tune_cpu_mesh_summary / knob_sweep)
    ((16, 16, 16), dict(p1=2, t1=2, t2=1, w1=0, w2=0, s1=1, v=1)),
    ((32, 32, 32), dict(p1=2, t1=1, t2=2, w1=0, w2=1, v=1)),
    ((64, 64, 64), dict(p1=2, t1=1, t2=1, w1=0, w2=0, s1=1, s2=1, v=2)),
    ((32, 64, 256), dict(p1=2, t1=4, t2=4, w1=0, w2=0)),
    ((16, 128, 512), dict(p1=2, t1=4, t2=4, w1=1, w2=1)),
]


def main():
    assert len(jax.devices()) >= 8, "set xla_force_host_platform_device_count"
    mesh = make_mesh(2, 4)
    rows = []
    for shape, best_cfg in CASES:
        rng = np.random.default_rng(0)
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        # (a) old round-4 heuristic
        nx, _, nz = shape
        t1o = min(4, max(1, nx // 2))
        t2o = min(4, max(1, nz // 4))
        old = PlanParams(p1=2, t1=t1o, t2=t2o, w1=min(2, t1o),
                         w2=min(2, t2o), engine="matmul")
        p_old = offt_tpu.plan(shape, "complex64", mesh=mesh, params=old)
        # (b) the shipped pick (wisdom/class heuristic)
        p_new = offt_tpu.plan(shape, "complex64", mesh=mesh)
        # (c) receipted best
        best = PlanParams(engine="matmul", **best_cfg)
        p_best = offt_tpu.plan(shape, "complex64", mesh=mesh, params=best)
        ms_old = time_plan(p_old, x)
        ms_new = time_plan(p_new, x)
        ms_best = time_plan(p_best, x)
        row = {"mesh": [2, 4], "shape": list(shape),
               "old_default_ms": round(ms_old, 3),
               "shipped_ms": round(ms_new, 3),
               "tuned_best_ms": round(ms_best, 3),
               "shipped_params": {k: v for k, v in (
                   ("t1", p_new.params.t1), ("t2", p_new.params.t2),
                   ("w1", p_new.params.w1), ("s1", p_new.params.s1),
                   ("v", p_new.params.v))},
               "shipped_vs_best": round(ms_new / ms_best, 3),
               "shipped_vs_old": round(ms_old / ms_new, 3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    with open(OUT, "a") as fh:
        fh.write(json.dumps({"what": "shipped dist defaults vs tuned best, "
                             "8-dev CPU mesh (VERDICT r4 #2)"}) + "\n")
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    bad = [r for r in rows if r["shipped_vs_best"] > 1.15]
    print(f"# {len(rows)} cases; within-noise (<=1.15x of best): "
          f"{len(rows) - len(bad)}; outliers: "
          f"{[(r['shape'], r['shipped_vs_best']) for r in bad]}")


if __name__ == "__main__":
    main()
