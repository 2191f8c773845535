"""Tuner acceptance tests on synthetic objectives with known optima —
mirroring Active Harmony's example/client_api quadratic acceptance test
(SURVEY.md §4.4)."""

import numpy as np
import pytest

from offt_tpu.tune.space import build_space
from offt_tpu.tune.strategies import make_strategy
from offt_tpu.tune.synth import AH_OPTIMUM, ah_quadratic, quadratic_space
from offt_tpu.tune.tuner import Tuner
from offt_tpu.plan.params import PlanParams, ProblemSpec


def run_synthetic(strategy_name, max_trials=400, seed=1):
    space = quadratic_space()
    tuner = Tuner(space, objective=ah_quadratic, strategy=strategy_name,
                  max_trials=max_trials, seed=seed)
    best, perf = tuner.run()
    return best, perf, tuner


def test_random_improves():
    best, perf, _ = run_synthetic("random", max_trials=300)
    rng = np.random.default_rng(0)
    base = ah_quadratic([int(rng.integers(1, 101)) for _ in range(6)])
    assert perf < base  # beats a single random draw with high probability
    assert perf < 6 * 50 ** 2


def test_nm_converges_to_optimum():
    best, perf, tuner = run_synthetic("nm", max_trials=500, seed=3)
    # NM on a quadratic should land at (or within a grid step of) the optimum
    assert perf <= 30, f"nm best {best} perf {perf}"


def test_pro_converges():
    best, perf, tuner = run_synthetic("pro", max_trials=500, seed=3)
    # PRO trades final precision for batch parallelism: expect within a few
    # grid steps per dimension of the optimum
    assert perf <= 150, f"pro best {best} perf {perf}"
    assert tuner.strategy.converged()


def test_brute_exhaustive_tiny():
    from offt_tpu.tune.space import Dimension
    from offt_tpu.tune.synth import _SynthSpace
    spec = ProblemSpec(shape=(1, 1, 1))
    space = _SynthSpace(
        spec=spec,
        dims=tuple(Dimension(f"v{i}", tuple(range(10, 21))) for i in range(2)),
    )
    obj = lambda vals: (vals[0] - 15) ** 2 + (vals[1] - 17) ** 2
    tuner = Tuner(space, objective=obj, strategy="brute", max_trials=10_000)
    best, perf = tuner.run()
    assert best == (15, 17)
    assert perf == 0


def test_memoization():
    space = quadratic_space()
    calls = []

    def obj(vals):
        calls.append(vals)
        return ah_quadratic(vals)

    strat = make_strategy("random", space, seed=0)
    tuner = Tuner(space, objective=obj, strategy=strat, max_trials=50)
    tuner.run()
    # every objective call must be unique (duplicates served from the DB)
    assert len(calls) == len({tuple(c) for c in calls})


def test_error_scores_inf_and_continues():
    space = quadratic_space()
    n_calls = [0]

    def obj(vals):
        n_calls[0] += 1
        if n_calls[0] % 3 == 0:
            raise RuntimeError("simulated compile OOM")
        return ah_quadratic(vals)

    tuner = Tuner(space, objective=obj, strategy="random", max_trials=30)
    best, perf = tuner.run()
    assert perf < float("inf")
    errs = [t for t in tuner.trials if t.status == "error"]
    assert errs, "expected some errored trials"


def test_fft_space_feasibility_filter():
    spec = ProblemSpec(shape=(16, 16, 16), p=8)
    space = build_space(spec)
    # every dimension value list is non-empty and p1 grid is legal
    assert all(len(d) >= 1 for d in space.dims)
    p1_dim = space.dims[space.names.index("p1")]
    for p1 in p1_dim.values:
        assert 8 % p1 == 0
    # infeasible points are detected (w > t)
    names = space.names
    pt = list(space.from_params(space.to_params(tuple(0 for _ in names))))
    it1, iw1 = names.index("t1"), names.index("w1")
    pt[it1] = 0   # t1 = 1
    pt[iw1] = len(space.dims[iw1].values) - 1  # w1 = max
    assert space.infeasible_reason(tuple(pt)) is not None


def test_engine_dimension_on_every_backend():
    """The local engine is a search dimension wherever the tuner runs, and
    a radix point on the XLA engine is rejected before it is timed."""
    from offt_tpu.plan.params import ENGINES

    space = build_space(ProblemSpec(shape=(16, 16, 16), p=1))
    assert space.dims[space.names.index("engine")].values == ENGINES
    pt = list(space.from_params(PlanParams()))
    pt[space.names.index("radix_z")] = 1       # a concrete factorization
    assert "engine" in space.infeasible_reason(tuple(pt))
    pt[space.names.index("engine")] = ENGINES.index("matmul")
    assert space.infeasible_reason(tuple(pt)) is None


def test_tune_end_to_end_tiny_fft(tmp_path, monkeypatch):
    """Full tune() over real (tiny) distributed FFT plans on the virtual
    CPU mesh, with a deterministic fake timer."""
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    from offt_tpu.dist import make_mesh
    from offt_tpu.tune import tune

    mesh = make_mesh(2, 4)

    # fake timer keyed on params so the search has a signal: pretend bigger
    # tiles are faster (monotone objective with known best)
    def fake_timer(plan):
        pp = plan.params
        return 1.0 / (pp.t1 + pp.t2) + 0.01 * pp.ry

    res = tune((16, 16, 16), "complex64", mesh=mesh, strategy="nm",
               max_trials=40, timer=fake_timer, include_radix=False, seed=2,
               log_path=str(tmp_path / "trials.jsonl"))
    assert res.best_perf <= res.default_perf
    # persistent cache got the best plan
    assert (tmp_path / "plan_cache.json").exists()
    # trial log is valid JSONL
    from offt_tpu.obs import read_events
    events = read_events(str(tmp_path / "trials.jsonl"))
    assert any(e["kind"] == "tune_done" for e in events)
    assert any(e["kind"] == "trial" for e in events)


def test_tune_trivial_space_returns_default(tmp_path, monkeypatch):
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    from offt_tpu.tune import tune

    res = tune((8, 8, 8), "complex64", strategy="nm", max_trials=5,
               timer=lambda plan: 0.123, include_radix=False)
    assert res.converged
    assert res.best_perf == 0.123


def test_hybrid_initial_simplex():
    from offt_tpu.tune.simplex import hybrid_initial_simplex

    spec = ProblemSpec(shape=(16, 16, 16), p=8)
    space = build_space(spec)
    pts = hybrid_initial_simplex(space, seed=3)
    assert len(pts) == len(space.dims) + 1
    assert len(set(pts)) == len(pts)  # distinct vertices
    # vertex 0 is the default heuristic point
    from offt_tpu.plan.params import default_params
    assert pts[0] == space.from_params(default_params(spec))
    # forced P1 coverage: slab-both-ways and near-square present
    i_p1 = space.names.index("p1")
    p1_vals = {space.dims[i_p1].values[pt[i_p1]] for pt in pts}
    assert {1, 8} <= p1_vals


def test_expression_constraints():
    spec = ProblemSpec(shape=(64, 64, 64), p=8)
    space = build_space(spec, include_radix=False,
                        constraints=("t1 <= t2", "w1 + w2 <= 4"))
    names = space.names
    pt = list(space.from_params(space.to_params((0,) * len(names))))
    pt[names.index("t1")] = 2   # t1 = 4
    pt[names.index("t2")] = 0   # t2 = 1
    assert "constraint violated" in space.infeasible_reason(tuple(pt))
    pt[names.index("t2")] = 2
    assert space.infeasible_reason(tuple(pt)) is None
    bad = build_space(spec, include_radix=False,
                      constraints=("nonsense ===",))
    assert "errored" in bad.infeasible_reason(tuple(0 for _ in bad.dims))


def test_constraint_eval_is_sandboxed():
    """Constraint strings must reject attribute chains / subscripts — eval()
    with empty __builtins__ was escapable (ADVICE round 1)."""
    from offt_tpu.tune.space import eval_constraint

    assert eval_constraint("min(t1, 3) + 1 <= t2 * 2", {"t1": 4, "t2": 2})
    assert not eval_constraint("t1 < 2", {"t1": 4})
    for evil in ("().__class__", "t1.__class__", "[1][0]",
                 "(lambda: 1)()", "__import__('os')"):
        with pytest.raises(Exception):
            eval_constraint(evil, {"t1": 1})


def test_inverse_tune_spec_bounds():
    """t1/t2 feasibility bounds follow the pipeline orientation: the inverse
    chunks z in phase 1 and x in phase 2 (ADVICE round 1 plan_key item)."""
    from offt_tpu.plan.params import (PlanParams, ProblemSpec,
                                      infeasible_reason)

    # 32 x 8 x 64 on a 4x2 mesh: fwd phase1 chunks x rows (32/4 = 8),
    # inverse phase1 chunks z planes (64/2 = 32)
    fwd = ProblemSpec(shape=(32, 8, 64), p=8)
    inv = ProblemSpec(shape=(32, 8, 64), p=8, inverse=True)
    p = PlanParams(p1=4, t1=16, t2=1)
    assert infeasible_reason(fwd, p) is not None      # 16 > 8
    assert infeasible_reason(inv, p) is None          # 16 <= 32
    q = PlanParams(p1=4, t1=1, t2=16)
    assert infeasible_reason(fwd, q) is None          # 16 <= 32
    assert infeasible_reason(inv, q) is not None      # 16 > 8


def test_phase_trials_truncate_work():
    """FAST_TUNING trial programs execute only the first k chunks of each
    phase (offt-compute.c:3538-3548 parity): the phase-1 trial output
    covers ~k/t of the chunked rows, and extrapolation weights are t/k."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    from offt_tpu.dist import make_mesh
    from offt_tpu.dist.pencil import make_phase_trials
    from offt_tpu.plan.params import PlanParams

    mesh = make_mesh(2, 4)
    shape = (32, 32, 32)
    params = PlanParams(p1=2, t1=8, t2=8, w1=2, w2=2)
    (fn1, spec1, shp1, w1), (fn2, spec2, shp2, w2) = make_phase_trials(
        mesh, 3, params, shape, k=2)
    assert w1 == 4.0 and w2 == 4.0
    rng = np.random.default_rng(0)
    x = jax.device_put(
        (rng.standard_normal(shp1) + 1j * rng.standard_normal(shp1)
         ).astype(np.complex64), NamedSharding(mesh, spec1))
    mid = fn1(x)
    # phase 1 chunks the local x rows (32/2 = 16 per device, 8 chunks of
    # 2); k=2 chunks -> 2*2 local rows -> global x extent 2*2*2 = 8
    assert mid.shape == (8, 32, 32)
    m = jax.device_put(
        (rng.standard_normal(shp2) + 1j * rng.standard_normal(shp2)
         ).astype(np.complex64), NamedSharding(mesh, spec2))
    out = fn2(m)
    # phase 2 chunks the local z extent (32/4 = 8, 8 chunks of 1); k=2 ->
    # 2 local planes -> global 2*4 = 8
    assert out.shape[0] == shp2[0] and out.shape[2] == 8


def test_tune_fast_trial_end_to_end(tmp_path, monkeypatch):
    """tune(fast_trial=k) searches on trial estimates and re-measures the
    finalists exactly; the result is a feasible, usable plan."""
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    import numpy as np

    import offt_tpu
    from offt_tpu.dist import make_mesh
    from offt_tpu.plan.params import ProblemSpec, is_feasible
    from offt_tpu.tune import tune

    mesh = make_mesh(2, 4)
    res = tune((16, 16, 16), "complex64", mesh=mesh, strategy="random",
               max_trials=4, include_radix=False, fast_trial=2,
               log_path=str(tmp_path / "log.jsonl"))
    spec = ProblemSpec(shape=(16, 16, 16), p=8)
    assert is_feasible(spec, res.best_params)
    assert res.best_perf > 0 and np.isfinite(res.best_perf)
    # the tuned plan actually runs
    p = offt_tpu.plan((16, 16, 16), "complex64", mesh=mesh,
                      params=res.best_params, planar=True)
    rng = np.random.default_rng(0)
    re = rng.standard_normal((16, 16, 16)).astype(np.float32)
    im = rng.standard_normal((16, 16, 16)).astype(np.float32)
    yr, yi = p((re, im))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    want = np.fft.fftn(re + 1j * im)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_tune_beats_or_matches_default(tmp_path, monkeypatch):
    """BASELINE bar: tuned >= default. The refinement pass re-measures
    both the finalists AND the default point exactly, so
    speedup_vs_default compares exact against exact and best <= default
    holds structurally (nm seeds vertex 0 with the default point)."""
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    from offt_tpu.dist import make_mesh
    from offt_tpu.tune import tune

    mesh = make_mesh(2, 4)
    res = tune((16, 16, 16), "complex64", mesh=mesh, strategy="nm",
               max_trials=6, include_radix=False,
               log_path=str(tmp_path / "log.jsonl"))
    assert res.speedup_vs_default >= 1.0


def test_layer_stack_filter_and_penalty():
    """session-core plugin-workflow parity: candidates run DOWN the layer
    stack (REJECT returns them to the strategy with a rejected() signal),
    reports run UP it (perf transforms)."""
    from offt_tpu.tune import FilterLayer, PenaltyLayer, Tuner
    from offt_tpu.tune.synth import _SynthSpace
    from offt_tpu.plan.params import ProblemSpec
    from offt_tpu.tune.space import Dimension

    space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)),
                        dims=(Dimension("a", tuple(range(10))),))

    def objective(vals):
        return float(vals[0])

    flt = FilterLayer(lambda vals: vals[0] % 2 == 0, name="even-only")
    pen = PenaltyLayer(lambda space, pt, perf: perf + 100.0)
    tuner = Tuner(space, objective, strategy="brute", max_trials=10,
                  layers=[flt, pen])
    best, perf = tuner.run()
    rejected = [t for t in tuner.trials if t.status == "rejected"]
    assert len(rejected) == 5                       # odd values filtered
    assert space.to_params(best) == (0,)            # best even value
    assert perf == 100.0                            # penalty applied upward


def test_layer_stack_transform():
    """A TransformLayer rewrite is evaluated, while the strategy is
    analyzed with the point IT generated (trial identity preserved)."""
    from offt_tpu.tune import TransformLayer, Tuner
    from offt_tpu.tune.synth import _SynthSpace
    from offt_tpu.plan.params import ProblemSpec
    from offt_tpu.tune.space import Dimension

    space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)),
                        dims=(Dimension("a", tuple(range(8))),))
    seen = []

    def objective(vals):
        seen.append(vals[0])
        return float(vals[0])

    # canonicalize to even (ADJUST_POINT analogue, offt-tuning.c:90-118)
    tl = TransformLayer(lambda sp, pt: (pt[0] - pt[0] % 2,))
    tuner = Tuner(space, objective, strategy="brute", max_trials=8,
                  layers=[tl])
    tuner.run()
    assert all(v % 2 == 0 for v in seen)            # evaluated canonical


def test_tune_fast_trial_real_and_inverse(tmp_path, monkeypatch):
    """fast_trial covers r2c and c2r too (offt-compute.c:3538-3548 wraps
    every phase incl. is_r2c): trial1 of a real-forward tune consumes the
    raw real z-pencil, and the c2r trials feed the half-spectrum."""
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    import numpy as np

    import offt_tpu
    from offt_tpu.dist import make_mesh
    from offt_tpu.plan.params import ProblemSpec, is_feasible
    from offt_tpu.tune import tune

    mesh = make_mesh(2, 4)
    res = tune((16, 16, 16), "complex64", mesh=mesh, real=True,
               strategy="random", max_trials=3, include_radix=False,
               fast_trial=2, log_path=str(tmp_path / "log.jsonl"))
    spec = ProblemSpec(shape=(16, 16, 16), p=8, real=True)
    assert is_feasible(spec, res.best_params)
    assert res.best_perf > 0 and np.isfinite(res.best_perf)
    p = offt_tpu.plan((16, 16, 16), "complex64", mesh=mesh, real=True,
                      params=res.best_params, planar=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 16, 16)).astype(np.float32)
    yr, yi = p(x)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    want = np.fft.rfftn(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5

    resi = tune((16, 16, 16), "complex64", mesh=mesh, real=True,
                inverse=True, strategy="random", max_trials=3,
                include_radix=False, fast_trial=2)
    speci = ProblemSpec(shape=(16, 16, 16), p=8, real=True, inverse=True)
    assert is_feasible(speci, resi.best_params)
    assert resi.best_perf > 0 and np.isfinite(resi.best_perf)
