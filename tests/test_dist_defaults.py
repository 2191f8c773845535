"""Distributed defaults (VERDICT r4 #2).

The reference's heuristic point is production-informed
(``params_set_default``, offt-compute.c:3127-3225). Here the p>1 defaults
encode the CPU-mesh receipts (docs/receipts/knob_sweep_cpu.jsonl,
tune_cpu_mesh_summary.jsonl); explicit params and ``use_cache=False``
always win over any cached point.
"""

import offt_tpu
from offt_tpu.dist import make_mesh
from offt_tpu.plan.params import PlanParams, ProblemSpec, default_params


def test_default_small_mesh_pipelines_unbounded():
    # p <= 8 class: t=4 chunks (2.3x receipt), w=0 unbounded in-flight
    d = default_params(ProblemSpec(shape=(32, 64, 256), p=8), p1=2)
    assert (d.t1, d.t2) == (4, 4)
    assert (d.w1, d.w2) == (0, 0)
    assert (d.s1, d.s2, d.v) == (0, 0, 0)


def test_default_large_mesh_no_chunking():
    # p >= 16 class: pipelining never recovers its dispatch overhead
    for p, p1 in ((16, 4), (32, 4), (64, 8)):
        d = default_params(ProblemSpec(shape=(32, 64, 256), p=p), p1=p1)
        assert (d.t1, d.t2, d.w1, d.w2) == (1, 1, 0, 0), (p, d)


def test_default_tiny_extent_clamps_tiles():
    # tiles stay bounded by the per-device extents on the small-mesh class
    d = default_params(ProblemSpec(shape=(8, 8, 8), p=8), p1=4)
    assert 1 <= d.t1 <= 2 and 1 <= d.t2 <= 4


def test_explicit_params_beat_wisdom():
    mesh = make_mesh(2, 4)
    mine = PlanParams(p1=2, t1=1, t2=1, w1=0, w2=0)
    p = offt_tpu.plan((16, 16, 16), "complex64", mesh=mesh, params=mine)
    assert p.params.t1 == 1 and p.params.v == 0


def test_use_cache_false_skips_wisdom():
    mesh = make_mesh(2, 4)
    p = offt_tpu.plan((16, 16, 16), "complex64", mesh=mesh, use_cache=False)
    assert p.params.v == 0 and p.params.s1 == 0
