"""The device layer: compile-cache directory selection and the roofline
peak table."""

import pathlib

import jax
import pytest

from offt_tpu.bench.roofline import DEVICES, device_spec, fft3d_roofline
from offt_tpu.utils import compile_cache

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_env_var(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert compile_cache.enable_compile_cache() == "/some/cache"
    # left to JAX: nothing set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_checkout_dir(monkeypatch,
                                               restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert pathlib.Path(got) == repo / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_dir_is_fixed(monkeypatch, restore_cache_dir):
    """The same directory every call (the path is part of the cache key):
    nothing from a temporary name, a pid or the time."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a = compile_cache.enable_compile_cache()
    b = compile_cache.enable_compile_cache()
    assert a == b == str(compile_cache.DEFAULT_DIR)
    assert ".jax_cache" in pathlib.Path(a).parts


def test_roofline_knows_h100():
    spec = device_spec(H100)
    assert spec.hbm_gbps == 3350.0 and spec.link_gbps == 450.0
    assert "data sheet" in spec.source
    assert set(DEVICES) == {H100}


def test_roofline_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        device_spec("cpu")
    with pytest.raises(ValueError):
        fft3d_roofline((64, 64, 64), "NVIDIA A100-SXM4-80GB")


def test_roofline_hbm_floor_256():
    """256^3 complex64: one read + one write of 128 MiB at 3.35 TB/s."""
    r = fft3d_roofline((256, 256, 256), H100)
    assert r.t_hbm_s == pytest.approx(2 * 128 * 2**20 / 3.35e12)
    assert r.t_link_s == 0.0 and r.bound == "hbm"
    assert r.efficiency(2 * r.t_bound_s) == pytest.approx(0.5)


def test_roofline_mesh_adds_nvlink_term():
    one = fft3d_roofline((512, 512, 512), H100)
    four = fft3d_roofline((512, 512, 512), H100, p1=2, p2=2)
    assert four.t_hbm_s == pytest.approx(one.t_hbm_s / 4)
    # each card sends half its 256 MiB in each of two phases over NVLink
    assert four.t_link_s == pytest.approx(256 * 2**20 / 450e9)
    assert four.bound == "nvlink"
