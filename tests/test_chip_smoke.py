"""chip_smoke.py on the CPU: it refuses to run without a GPU, ``--multi``
selects only the four-card phases, and every phase passes at a tiny size
on the virtual devices (the same code the card runs at full size)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_refuses_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")]
                         + args, capture_output=True, text=True, env=env,
                         cwd=str(REPO), timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""             # no result line at all
    assert "needs a GPU" in out.stderr


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "bench.py")],
                         capture_output=True, text=True, env=env,
                         cwd=str(REPO), timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs a GPU" in out.stderr


def test_multi_selects_only_four_card_phases():
    multi = chip_smoke.phases(multi=True)
    single = chip_smoke.phases(multi=False)
    assert set(multi) == {"pencil", "long1d", "batch"}
    assert set(single) == set("abcdefgh")
    assert not set(multi.values()) & set(single.values())


ONE_CARD = [("a", {"n": 16}), ("b", {"n": 16}), ("c", {"n": 32}),
            ("d", {"n": 16}), ("e", {"n": 1 << 12}), ("f", {"n": 16}),
            ("g", {"n": 16, "trials": 2}), ("h", {"n": 16})]


@pytest.mark.parametrize("name,kw", ONE_CARD, ids=[n for n, _ in ONE_CARD])
def test_one_card_phase_tiny(name, kw, capsys, monkeypatch, tmp_path):
    # phase h calls offt-bench's main, which enables the compile cache:
    # keep it out of the checkout
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert chip_smoke.SINGLE[name](**kw)
    assert "FAIL" not in capsys.readouterr().out


FOUR_CARD = [("pencil", {"n": 16}), ("long1d", {"n": 1 << 12}),
             ("batch", {"n": 16})]


@pytest.mark.parametrize("name,kw", FOUR_CARD, ids=[n for n, _ in FOUR_CARD])
def test_four_card_phase_tiny(name, kw, capsys):
    """The distributed phases on 4 of the 8 virtual CPU devices, with the
    check that each result's shards sit on 4 distinct devices."""
    assert chip_smoke.MULTI[name](count=4, **kw)
    assert "FAIL" not in capsys.readouterr().out


def test_golden_error_detects_a_wrong_spectrum():
    import jax.numpy as jnp
    import numpy as np

    n = 16
    i = np.arange(n)
    g = (i[None, None, :] + 10.0 * i[None, :, None]
         + 100.0 * i[:, None, None]).astype(np.complex128)
    y = np.fft.fftn(g)
    assert chip_smoke.golden_error(jnp.asarray(y), n) < 1e-12
    y[3, 4, 5] += 1e-3 * np.abs(y).max()
    assert chip_smoke.golden_error(jnp.asarray(y), n) > 1e-4


@pytest.mark.gpu
def test_last_line_contract_on_gpu(gpu):
    """On a card: the whole one-card run, last line as the contract says."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
