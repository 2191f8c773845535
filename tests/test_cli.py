"""CLI smoke tests (runfft driver + offt-tune) via subprocess on CPU."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_cli(args, timeout=110, tmp=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import tempfile
    env["OFFT_TPU_CACHE_DIR"] = tmp or tempfile.mkdtemp(prefix="offt_cli_")
    # the entry points' compile cache goes where the variable says
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
        env["OFFT_TPU_CACHE_DIR"], "jax_cache")
    # run the console-script mains in a fresh interpreter
    code = (
        "import sys; sys.argv = ['prog'] + %r;"
        "from offt_tpu.bench.runfft import main as m1;"
        "from offt_tpu.tune.cli import main as m2;"
        "tgt = m1 if %r == 'bench' else m2;"
        "raise SystemExit(tgt())"
    )
    kind = "bench" if args[0] == "bench" else "tune"
    out = subprocess.run(
        [sys.executable, "-c", code % (args[1:], kind)],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=timeout)
    return out


def test_runfft_offt_small():
    out = run_cli(["bench", "-N", "16", "-a", "offt", "-r", "2", "--verify"])
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["algo"] == "offt" and rec["t_ms"] > 0
    assert "verify rel_err" in out.stderr


def test_runfft_mesh():
    out = run_cli(["bench", "-N", "16", "-a", "offt", "--p1", "2",
                   "--p2", "4", "-r", "1", "--t1", "2", "--ry", "5"])
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["gflops"] > 0


def test_runfft_xla_sharded_crosscheck():
    """-a xla on a mesh runs GSPMD's own distributed FFT over the SAME
    pencil-sharded inputs — the in-driver third-party comparison
    (run-fft.c:312-353 analogue that actually executes here)."""
    out = run_cli(["bench", "-N", "16", "-a", "xla", "--p1", "2",
                   "--p2", "4", "-r", "1"])
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["xla_fn"] == "fftn@mesh"
    assert rec["gflops"] > 0


def test_runfft_numpy_baseline():
    out = run_cli(["bench", "-N", "16", "-a", "numpy", "-r", "1"])
    assert out.returncode == 0
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["algo"] == "numpy"


def test_offt_tune_pyfn():
    out = run_cli(["tune", "-i", "a:1:50", "-i", "b:1:50", "-s", "nm",
                   "-l", "60", "-q", "--pyfn",
                   "offt_tpu.tune.synth:_cli_test_obj"])
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["perf"] <= 9  # near the (20, 33) optimum


def test_runfft_tune_smoke():
    """offt-bench --tune end-to-end on the virtual mesh (tiny budget)."""
    out = run_cli(["bench", "-N", "16", "-a", "offt", "--p1", "2", "--p2",
                   "4", "--tune", "-l", "4", "-r", "1"], timeout=300)
    assert out.returncode == 0, out.stderr[-800:]
    assert "tuned: best=" in out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["t_ms"] > 0


def test_runfft_batch_with_override():
    """-b together with knob overrides used to crash plan() with a 4-D
    shape (ADVICE round 1, medium)."""
    out = run_cli(["bench", "-N", "8", "-b", "2", "-a", "offt", "-r", "1",
                   "--t1", "1", "--verify"])
    assert out.returncode == 0, out.stderr[-800:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["shape"] == [2, 8, 8, 8]


def test_offt_tune_method_user():
    """-m user measures child CPU time via RUSAGE_CHILDREN (tuna.c parity)."""
    out = run_cli(["tune", "-i", "a:1:4", "-s", "random", "-l", "3", "-q",
                   "-m", "user", "--",
                   sys.executable, "-c", "pass"])
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["best"] is not None and rec["perf"] > 0


def test_runfft_mesh_breakdown():
    out = run_cli(["bench", "-N", "16", "-a", "offt", "--p1", "2",
                   "--p2", "4", "-r", "1", "--breakdown"], timeout=240)
    assert out.returncode == 0, out.stderr[-800:]
    for key in ("exchange_1", "exchange_2", "overlap_gain"):
        assert key in out.stderr


def test_runfft_r2c_packed():
    out = run_cli(["bench", "-N", "8", "--nz", "256", "-a", "offt", "-R",
                   "--packed", "-r", "1", "--verify"], timeout=240)
    assert out.returncode == 0, out.stderr[-800:]
    assert "verify rel_err" in out.stderr


def test_runfft_c2r_inverse():
    out = run_cli(["bench", "-N", "16", "-a", "offt", "-R", "-i", "-r", "1"])
    assert out.returncode == 0, out.stderr[-800:]


def test_runfft_xla_honors_inverse_and_c2r():
    """The XLA baseline must bench the SAME transform as the offt config
    (a round-4 fix: -i silently benched fftn; -R -i benched rfftn on a
    half-spectrum-shaped input)."""
    out = run_cli(["bench", "-N", "16", "-a", "xla", "-i", "-r", "1"])
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["xla_fn"] == "ifftn"
    out = run_cli(["bench", "-N", "16", "-a", "xla", "-R", "-i", "-r", "1"])
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["xla_fn"] == "irfftn"
    # the packed layout has no XLA analogue: explicit error line, rc=2
    out = run_cli(["bench", "-N", "16", "-a", "xla", "-R", "--packed",
                   "-r", "1"])
    assert out.returncode == 2
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert "no XLA analogue" in rec["error"]


def test_runfft_jaxdecomp_not_installed():
    """The third-party-baseline flag degrades to a machine-readable JSON
    error line in environments without jaxdecomp."""
    out = run_cli(["bench", "-N", "16", "-a", "jaxdecomp", "-r", "1"])
    assert out.returncode == 2
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["algo"] == "jaxdecomp" and "not installed" in rec["error"]


def test_runfft_jaxdecomp_mode_rejected_early():
    """Unsupported jaxdecomp modes (r2c/inverse) are rejected BEFORE any
    tuning or device work, still emitting the one-JSON-line contract."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import sys, types; sys.modules['jaxdecomp'] = "
        "types.ModuleType('jaxdecomp');"   # satisfy the import gate only
        "sys.argv = ['prog', '-N', '16', '-a', 'jaxdecomp', '-R',"
        " '-r', '1'];"
        "from offt_tpu.bench.runfft import main;"
        "raise SystemExit(main())"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO), env=env, timeout=110)
    assert out.returncode == 2, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["error"] == "c2c forward only"
    assert "c2c forward only" in out.stderr
