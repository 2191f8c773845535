"""The tuning loop: candidate -> feasibility -> memo-DB -> build plan ->
time it -> report; plus the public ``tune()`` entry point.

Python/JAX re-expression of ``ah_tuning`` (/root/reference/offt-tuning.c:744-1022):

- single-controller JAX replaces rank-0 + MPI_Bcast of the chosen point
  (offt-tuning.c:920): every device sees the same trace by construction.
- the in-memory + JSONL point database replaces tmp-db-<rand>
  (offt-tuning.c:231-277); the *persistent* best-plan cache
  (plan/cache.py) is the cross-run upgrade BASELINE.md calls for.
- errored/infeasible candidates score +inf and the search continues,
  mirroring perf=99999999.0 (offt-tuning.c:906-907, offt-compute.c:3881).
- termination: max_trials feasible points, 10x total cap, or strategy
  convergence (offt-tuning.c:893).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from ..obs.log import EventLog
from ..plan import cache as plan_cache
from ..plan.api import Plan, plan as build_plan
from ..plan.params import PlanParams, ProblemSpec, default_params
from .space import Point, SearchSpace, build_space
from .strategies import Strategy, make_strategy

INF = float("inf")


def _default_timer(reps: int = 5) -> Callable[[Plan], float]:
    """Median seconds of one plan execution (obs/profile.py:time_fn) on
    random planar operands."""

    def timer(p: Plan) -> float:
        import jax

        from ..obs.profile import time_fn

        shape = (p.ndim - 3) * (1,) + tuple(p.spec.shape)
        if p.spec.real and p.spec.inverse:   # c2r input: half spectrum
            shape = shape[:-1] + (shape[-1] // 2 + 1,)
        rng = np.random.default_rng(0)
        rdt = np.float32 if "64" in p.spec.dtype else np.float64
        re = jax.device_put(rng.standard_normal(shape).astype(rdt))
        if p.spec.real and not p.spec.inverse:
            args = (re,)
        else:
            im = jax.device_put(rng.standard_normal(shape).astype(rdt))
            args = (re, im)
        return time_fn(p._fn, args, reps=reps).median

    return timer


@dataclasses.dataclass
class TrialRecord:
    point: Point
    params: Optional[PlanParams]
    perf: float
    status: str  # ok | infeasible | duplicate | error


@dataclasses.dataclass
class TuneResult:
    best_params: PlanParams
    best_perf: float
    default_perf: float
    trials: list[TrialRecord]
    converged: bool

    @property
    def speedup_vs_default(self) -> float:
        if self.best_perf <= 0 or self.default_perf == INF:
            return float("nan")
        return self.default_perf / self.best_perf


class Tuner:
    """Strategy-driven search with memoization and structured logging.

    ``compile_fn``/``measure_fn`` split the objective into a (thread-
    parallelizable) build/compile stage and a (device-serial) measurement
    stage — the analogue of Active Harmony's async codegen plugin
    (plugins/codegen.c: points are released to clients only after their
    code variant is built). With a batch-capable strategy (PRO hands out a
    whole simplex per round, pro.c:326-343) up to ``batch`` candidates
    compile concurrently while the device measures the previous one.
    """

    def __init__(
        self,
        space: SearchSpace,
        objective: Optional[Callable[[PlanParams], float]] = None,
        strategy: str | Strategy = "nm",
        max_trials: int = 50,
        seed: int = 0,
        log: Optional[EventLog] = None,
        init_points: Optional[list[PlanParams]] = None,
        compile_fn: Optional[Callable[[PlanParams], object]] = None,
        measure_fn: Optional[Callable[[object], float]] = None,
        batch: int = 4,
        layers=(),
    ):
        if objective is None and not (compile_fn and measure_fn):
            raise ValueError("need objective or compile_fn+measure_fn")
        self.compile_fn = compile_fn
        self.measure_fn = measure_fn
        self.batch = max(1, batch)
        self.space = space
        self.objective = objective
        if isinstance(strategy, str):
            init_simplex = None
            if init_points:
                init_simplex = [space.from_params(p) for p in init_points]
            kw = {"seed": seed}
            if strategy in ("nm", "pro"):
                kw["init_simplex"] = init_simplex
                # SIMPLEX_SIZE config key (defaults.h analogue); 0 = n+1
                from ..utils import config as _cfg
                size = int(_cfg.get("simplex_size"))
                if size > 0:
                    kw["size"] = size
            self.strategy: Strategy = make_strategy(strategy, space, **kw)
        else:
            self.strategy = strategy
        self.max_trials = max_trials
        self.log = log or EventLog()
        self.db: dict[Point, float] = {}
        self.trials: list[TrialRecord] = []
        # plugin layer stack (session-core.c:334-445 workflow): candidates
        # run DOWN the stack before evaluation, reports run UP it
        self.layers = tuple(layers)
        self._replaced: dict[Point, Point] = {}

    def load_db(self, log_path: str) -> int:
        """Resume memoization from a previous run's JSONL trial log — the
        cross-run upgrade of the reference's per-run tmp-db point database
        (offt-tuning.c:231-277, deleted at session start)."""
        from ..obs.log import read_events

        n = 0
        try:
            for ev in read_events(log_path):
                if ev.get("kind") == "trial" and "perf" in ev:
                    perf = float(ev["perf"])
                    # sanitize: no real plan executes in <100ns; such
                    # entries are artifacts of broken timers and would
                    # poison the search as unbeatable "best" points
                    if perf < 1e-7:
                        continue
                    self.db[tuple(ev["point"])] = perf
                    n += 1
        except FileNotFoundError:
            pass
        return n

    def _drain_batch(self, budget_left: int,
                     total_left: int) -> tuple[list[Point], int, bool]:
        """Pull up to ``batch`` fresh feasible points from the strategy,
        replaying memo hits / rejecting infeasible ones inline. Returns
        (fresh_points, total_generated, exhausted)."""
        fresh: list[Point] = []
        total = 0
        limit = min(self.batch, budget_left)
        while len(fresh) < limit and total < total_left:
            if self.strategy.converged():
                return fresh, total, True
            point = self.strategy.generate()
            if point is None:
                return fresh, total, not fresh
            total += 1
            reason = self.space.infeasible_reason(point)
            if reason is not None:
                self.trials.append(TrialRecord(point, None, INF, "infeasible"))
                self.log.emit("trial", point=list(point), status="infeasible",
                              reason=reason)
                self.strategy.rejected(point)
                continue
            if self.layers:
                from .layers import REJECT, run_generation

                orig = point
                action, point, lreason = run_generation(
                    self.layers, self.space, orig)
                if action == REJECT:
                    self.trials.append(
                        TrialRecord(orig, None, INF, "rejected"))
                    self.log.emit("trial", point=list(orig),
                                  status="rejected", reason=lreason)
                    self.strategy.rejected(orig)
                    continue
                point = tuple(point)
                if point != orig:
                    # the strategy is analyzed with ITS point (id-stable,
                    # session-core keeps trial identity across rewrites)
                    self._replaced[point] = orig
            if point in self.db:  # memo hit (is_in_database_point analogue)
                perf = self.db[point]
                self.trials.append(
                    TrialRecord(point, self.space.to_params(point), perf,
                                "duplicate"))
                self.strategy.analyze(point, perf)
                continue
            if point in fresh:
                # sequential strategies (NM) re-offer their pending point
                # until it is analyzed: stop draining and evaluate
                total -= 1
                break
            fresh.append(point)
        return fresh, total, False

    def _evaluate_batch(self, points: list[Point]) -> None:
        """Compile candidates concurrently (when split-stage fns are set),
        then measure serially on the device."""
        params_list = [self.space.to_params(p) for p in points]
        handles: list = [None] * len(points)
        errors: list = [None] * len(points)
        if self.compile_fn is not None:
            if len(points) > 1:
                import concurrent.futures as cf

                with cf.ThreadPoolExecutor(max_workers=len(points)) as pool:
                    futs = [pool.submit(self.compile_fn, pp)
                            for pp in params_list]
                    for i, f in enumerate(futs):
                        try:
                            handles[i] = f.result()
                        except Exception as e:
                            errors[i] = e
            else:
                try:
                    handles[0] = self.compile_fn(params_list[0])
                except Exception as e:
                    errors[0] = e
        for point, params, handle, err in zip(points, params_list, handles,
                                              errors):
            status = "ok"
            if err is not None:
                perf = INF
                status = "error"
                self.log.emit("trial_error", point=list(point),
                              error=repr(err))
            else:
                try:
                    if self.measure_fn is not None:
                        perf = float(self.measure_fn(handle))
                    else:
                        perf = float(self.objective(params))
                except Exception as e:  # compile/OOM -> +inf, continue
                    perf = INF
                    status = "error"
                    self.log.emit("trial_error", point=list(point),
                                  error=repr(e))
            if self.layers:
                from .layers import run_analysis

                perf = run_analysis(self.layers, self.space, point, perf)
            self.db[point] = perf
            self.trials.append(TrialRecord(point, params, perf, status))
            self.log.emit("trial", point=list(point), perf=perf,
                          status=status)
            # a transform layer may have rewritten the point; the strategy
            # is analyzed with the point IT generated
            self.strategy.analyze(self._replaced.get(point, point), perf)

    def run(self) -> tuple[Optional[PlanParams], float]:
        feasible = 0
        total = 0
        while feasible < self.max_trials and total < 10 * self.max_trials:
            fresh, generated, exhausted = self._drain_batch(
                self.max_trials - feasible, 10 * self.max_trials - total)
            total += generated
            if fresh:
                self._evaluate_batch(fresh)
                feasible += len(fresh)
            if exhausted and not fresh:
                break
            if not fresh and generated == 0:
                break  # strategy stalled (waiting with nothing outstanding)
        # the tuner's own DB is authoritative for "best measured point"
        # (strategies may track best over *snapped* retries differently)
        if not self.db:
            return None, INF
        best_pt, best_perf = min(self.db.items(), key=lambda kv: kv[1])
        if best_perf == INF:
            return None, INF
        return self.space.to_params(best_pt), best_perf


def tune(
    shape: tuple[int, int, int],
    dtype="complex64",
    *,
    mesh=None,
    real: bool = False,
    inverse: bool = False,
    strategy: str = None,
    max_trials: int = None,
    timer: Optional[Callable[[Plan], float]] = None,
    seed: int = 0,
    log_path: Optional[str] = None,
    save: bool = True,
    include_radix: bool = True,
    fast_trial: int = 0,
) -> TuneResult:
    """Auto-tune a 3-D FFT plan for (shape, dtype, mesh); returns the best
    PlanParams and writes them to the persistent plan cache. Forward and
    inverse transforms are tuned (and cached) separately — their pipelines
    chunk different axes per phase.

    ``fast_trial=k`` (distributed plans, incl. r2c/c2r and inverse)
    enables FAST_TUNING-style
    trials (offt-compute.c:3538-3548, driver -A): each candidate is timed
    on truncated per-phase programs executing only the first k pipeline
    chunks, extrapolated by t/k — trial cost drops ~t/k at large shapes.
    The top-3 finalists are always re-measured exactly before a winner is
    declared (the refinement pass)."""
    import jax
    import jax.numpy as jnp

    from ..utils import config as _cfg

    # layered config (defaults < file < env < kwargs), hcfg.c analogue
    strategy = _cfg.get("strategy", strategy=strategy)
    max_trials = int(_cfg.get("max_trials", max_trials=max_trials))
    batch = max(1, int(_cfg.get("prefetch_count")))

    p = 1
    if mesh is not None:
        from ..dist.mesh import mesh_shape as _ms
        p = _ms(mesh)[0] * _ms(mesh)[1]
    fixed_p1 = None
    if mesh is not None:
        from ..dist.mesh import mesh_shape
        fixed_p1 = mesh_shape(mesh)[0]
    spec = ProblemSpec(shape=tuple(shape), dtype=str(jnp.dtype(dtype)),
                       real=real, inverse=inverse, p=p)
    space = build_space(spec, fixed_p1=fixed_p1, include_radix=include_radix)
    user_timer = timer
    timer = timer or _default_timer()
    log = EventLog(log_path)

    def objective(params: PlanParams) -> float:
        pl = build_plan(shape, dtype, mesh=mesh, real=real, inverse=inverse,
                        params=params, use_cache=False, planar=True)
        return timer(pl)

    # split-stage path: AOT-compile candidates in threads (the codegen-
    # plugin analogue) while the device measures serially; only with the
    # default timer (custom timers expect a Plan, not a compiled handle)
    compile_fn = measure_fn = None
    if user_timer is None:
        import jax as _jax

        rng = np.random.default_rng(0)
        rdt = np.float32 if "64" in spec.dtype else np.float64
        in_shape = tuple(shape)
        if real and inverse:                  # c2r input: half spectrum
            in_shape = in_shape[:-1] + (in_shape[-1] // 2 + 1,)
        _re = _jax.device_put(rng.standard_normal(in_shape).astype(rdt))
        if real and not inverse:
            shared_args = (_re,)
        else:
            _im = _jax.device_put(rng.standard_normal(in_shape).astype(rdt))
            shared_args = (_re, _im)
        avals = tuple(_jax.ShapeDtypeStruct(a.shape, a.dtype)
                      for a in shared_args)

        def compile_fn(params: PlanParams):
            pl = build_plan(shape, dtype, mesh=mesh, real=real,
                            inverse=inverse, params=params,
                            use_cache=False, planar=True)
            return pl._fn.lower(*avals).compile()

        from ..obs.profile import time_fn

        def _measure(compiled, reps: int) -> float:
            return time_fn(compiled, shared_args, reps=reps).median

        # FAST_TUNING analogue (offt-compute.c:3538-3548 extrapolation
        # window): coarse timing during the search, precise re-measurement
        # of the top candidates afterwards (see refinement below)
        handle_by_params: dict = {}
        _exact_compile = compile_fn

        # degenerate (1, 1, n) mesh plans route to the distributed 1-D
        # engine (dist/long1d.py), whose cost structure the pencil phase
        # trials do not model — tune those with exact full-plan timing
        use_trial = (bool(fast_trial) and mesh is not None
                     and tuple(shape[-3:-1]) != (1, 1))
        if use_trial:
            import jax.numpy as _jnp
            from jax.sharding import NamedSharding

            from ..dist.pencil import make_phase_trials
            from ..plan.api import real_stage_fns

            nzf_trial = (shape[-1] // 2 + 1) if real else 0

            def _trial_compile(params: PlanParams):
                first_fn, last_fn = real_stage_fns(
                    params, shape[-1], packed=False, inverse=inverse,
                    real=real)
                trials = make_phase_trials(
                    mesh, 3, params, tuple(shape), inverse=inverse,
                    rad_z=None if real else params.radix_z,
                    rad_y=params.radix_y, rad_x=params.radix_x,
                    k=int(fast_trial), first_fn=first_fn, last_fn=last_fn,
                    z_freq_len=nzf_trial)
                out = []
                trng = np.random.default_rng(1)  # thread-local (batch compiles)
                for idx, (fn, sspec, shp, w) in enumerate(trials):
                    # a real-forward trial1 consumes the raw REAL z-pencil
                    # (its first_fn does the fold); every other trial is
                    # complex-in, fed as a planar pair
                    real_in = real and not inverse and idx == 0
                    sh = NamedSharding(mesh, sspec)
                    if real_in:
                        def planar(r, _fn=fn):
                            c = _fn(r)
                            return _jnp.real(c), _jnp.imag(c)
                        tr = _jax.device_put(
                            trng.standard_normal(shp).astype(np.float32), sh)
                        args = (tr,)
                        shards = (sh,)
                    else:
                        def planar(r, i, _fn=fn):
                            c = _fn(_jax.lax.complex(r, i))
                            return _jnp.real(c), _jnp.imag(c)
                        tr = _jax.device_put(
                            trng.standard_normal(shp).astype(np.float32), sh)
                        ti = _jax.device_put(
                            trng.standard_normal(shp).astype(np.float32), sh)
                        args = (tr, ti)
                        shards = (sh, sh)
                    tav = tuple(_jax.ShapeDtypeStruct(a.shape, a.dtype)
                                for a in args)
                    compiled = _jax.jit(
                        planar, in_shardings=shards).lower(*tav).compile()
                    out.append((compiled, args, w))
                return tuple(out)

            def compile_fn(params: PlanParams):
                h = _trial_compile(params)
                handle_by_params[params] = params  # refine rebuilds exact
                return h

            def measure_fn(handle) -> float:
                return sum(w * time_fn(c, a, reps=3).median
                           for c, a, w in handle)
        else:
            def compile_fn(params: PlanParams):
                h = _exact_compile(params)
                handle_by_params[params] = h
                return h

            def measure_fn(compiled) -> float:
                return _measure(compiled, reps=3)

    # seed the search with the hybrid-random initial simplex (default
    # heuristic point first, forced P1 coverage, biased random rest —
    # write_initial_simplex parity, offt-tuning.c:426-738)
    from .simplex import hybrid_initial_simplex

    dflt = default_params(spec, p1=fixed_p1)
    dflt_point = space.from_params(dflt)
    init_simplex = hybrid_initial_simplex(space, seed=seed)
    tuner = Tuner(space, objective, strategy=strategy, max_trials=max_trials,
                  seed=seed, log=log, batch=batch,
                  init_points=[space.to_params(pt) for pt in init_simplex],
                  compile_fn=compile_fn, measure_fn=measure_fn)
    if log_path:
        resumed = tuner.load_db(log_path)
        if resumed:
            log.emit("resume", memoized=resumed)
    t0 = time.time()
    best_params, best_perf = tuner.run()

    # refinement pass: the search ranked candidates with a coarse (or
    # FAST_TUNING-extrapolated) timer; re-measure the top few EXACTLY
    # before declaring a winner
    if user_timer is None and tuner.db:
        ranked = sorted(tuner.db.items(), key=lambda kv: kv[1])[:3]
        # always re-measure the default heuristic point exactly as well,
        # so speedup_vs_default compares exact against exact (and best
        # <= default holds structurally when both were refined)
        if dflt_point in tuner.db and dflt_point not in [p for p, _ in
                                                         ranked]:
            ranked.append((dflt_point, tuner.db[dflt_point]))
        for pt, coarse in ranked:
            pp = space.to_params(pt)
            h = handle_by_params.get(pp)
            if h is None:
                continue
            if use_trial:
                try:
                    h = _exact_compile(pp)   # full plan, not the trial
                except Exception:
                    continue
            precise = _measure(h, reps=10)
            tuner.db[pt] = precise
            log.emit("refine", point=list(pt), coarse=coarse, perf=precise)
        best_pt, best_perf = min(
            ((pt, tuner.db[pt]) for pt, _ in ranked), key=lambda kv: kv[1])
        best_params = space.to_params(best_pt)

    default_perf = tuner.db.get(dflt_point)
    if default_perf is None:
        try:
            default_perf = objective(space.to_params(dflt_point))
        except Exception:
            default_perf = INF
    if best_params is None or best_perf == INF:
        best_params, best_perf = space.to_params(dflt_point), default_perf
    log.emit("tune_done", best=dataclasses.asdict(best_params),
             best_perf=best_perf, default_perf=default_perf,
             wall=round(time.time() - t0, 3),
             trials=len(tuner.trials))
    if save:
        p1 = fixed_p1 or best_params.p1
        p2 = p // max(p1, 1)
        dev_kind = (mesh.devices.flat[0].device_kind if mesh is not None
                    else jax.devices()[0].device_kind)
        plan_cache.store(
            plan_cache.plan_key(shape, spec.dtype, real, p1, p2, dev_kind,
                                inverse=inverse),
            best_params, perf=best_perf)
    log.close()
    return TuneResult(best_params=best_params, best_perf=best_perf,
                      default_perf=default_perf, trials=tuner.trials,
                      converged=tuner.strategy.converged())
