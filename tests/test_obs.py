"""Observability: event log, per-stage breakdown, tuner resume."""

import numpy as np

from offt_tpu.obs import EventLog, read_events
from offt_tpu.obs.profile import fft3d_breakdown, time_fn


def test_event_log_roundtrip(tmp_path):
    p = tmp_path / "ev.jsonl"
    with EventLog(str(p)) as log:
        log.emit("trial", point=[1, 2], perf=0.5)
        log.emit("tune_done", best_perf=0.5)
    evs = read_events(str(p))
    assert [e["kind"] for e in evs] == ["trial", "tune_done"]
    assert evs[0]["point"] == [1, 2]


def test_time_fn_runs():
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a, b: (a + b, a - b))
    x = jnp.ones((64, 64))
    t = time_fn(f, (x, x), reps=3, warmup=1)
    assert len(t.times) == 3 and t.min > 0
    assert t.min <= t.median <= t.max and t.spread >= 0


def test_breakdown_local():
    bd = fft3d_breakdown((16, 16, 16))
    assert set(bd) >= {"fft_z", "fft_y", "fft_x", "total_fused", "stage_sum"}
    assert all(v > 0 for k, v in bd.items() if k != "fusion_gain")


def test_tuner_resume(tmp_path):
    from offt_tpu.tune.synth import ah_quadratic, quadratic_space
    from offt_tpu.tune.tuner import Tuner

    space = quadratic_space()
    log_path = str(tmp_path / "trials.jsonl")
    t1 = Tuner(space, ah_quadratic, strategy="random", max_trials=20,
               seed=1, log=EventLog(log_path))
    t1.run()
    t1.log.close()

    calls = []

    def counting_obj(vals):
        calls.append(vals)
        return ah_quadratic(vals)

    t2 = Tuner(space, counting_obj, strategy="random", max_trials=20, seed=1,
               log=EventLog(str(tmp_path / "t2.jsonl")))
    resumed_points = set(t1.db)
    n = t2.load_db(log_path)
    assert n == 20
    t2.run()
    # memoized points are never re-measured (they also don't consume the
    # trial budget, matching is_in_database_point semantics)
    measured_points = {space.from_params(c) for c in calls}
    assert measured_points.isdisjoint(resumed_points)
    dup = [t for t in t2.trials if t.status == "duplicate"]
    assert len(dup) >= 20  # the first 20 candidates replayed from the DB


def test_view_summarize(tmp_path):
    from offt_tpu.obs.view import main, summarize

    p = tmp_path / "t.jsonl"
    with EventLog(str(p)) as log:
        log.emit("trial", point=[0, 1], perf=0.002, status="ok")
        log.emit("trial", point=[1, 1], perf=0.001, status="ok")
        log.emit("trial", point=[0, 1], perf=0.002, status="duplicate")
        log.emit("trial", point=[9, 9], status="infeasible", reason="x")
        log.emit("trial_error", point=[2, 2], error="boom")
        log.emit("tune_done", best_perf=0.001, default_perf=0.002)
    s = summarize(str(p))
    assert s["trials"] == 4 and s["ok"] == 2 and s["errors"] == 1
    assert s["best"][0]["point"] == [1, 1]
    assert main([str(p)]) == 0
    assert main([str(p), "--json"]) == 0


def test_pencil_breakdown_mesh():
    """Distributed per-phase split (offt.h:171-188 parity): five stage
    timings + the measured overlap/fusion gain on the 8-device mesh."""
    from offt_tpu.dist import make_mesh
    from offt_tpu.obs.profile import pencil_breakdown

    bd = pencil_breakdown((16, 16, 16), make_mesh(2, 4))
    for key in ("fft_z", "exchange_1", "fft_y", "exchange_2", "fft_x",
                "total_fused", "stage_sum", "overlap_gain"):
        assert key in bd
    assert all(v > 0 for k, v in bd.items() if k != "overlap_gain")
    assert abs(bd["stage_sum"] - bd["overlap_gain"]
               - bd["total_fused"]) < 1e-12
    import pytest

    with pytest.raises(ValueError):
        pencil_breakdown((15, 16, 16), make_mesh(2, 4))  # not divisible
