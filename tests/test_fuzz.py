"""Seeded property fuzz: random shapes x meshes x transform kinds must
match numpy and roundtrip, including uneven/padded cases."""

import numpy as np
import pytest

import offt_tpu
from offt_tpu.dist import make_mesh


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a.ravel() - b.ravel()) / max(np.linalg.norm(b.ravel()), 1e-30)


MESHES = [None, (1, 1), (2, 4), (4, 2), (8, 1), (1, 8), (2, 2)]


@pytest.mark.parametrize("trial", range(10))
def test_fuzz_c2c(trial):
    rng = np.random.default_rng(1000 + trial)
    shape = tuple(int(rng.integers(4, 21)) for _ in range(3))
    mesh_cfg = MESHES[int(rng.integers(0, len(MESHES)))]
    mesh = make_mesh(*mesh_cfg) if mesh_cfg else None
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex128)
    got = offt_tpu.fft3d(x, mesh=mesh)
    assert rel_err(got, np.fft.fftn(x)) < 1e-11, (shape, mesh_cfg)
    back = offt_tpu.ifft3d(np.asarray(got), mesh=mesh)
    assert rel_err(back, x) < 1e-11, (shape, mesh_cfg)


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_r2c(trial):
    rng = np.random.default_rng(2000 + trial)
    shape = tuple(int(rng.integers(4, 19)) for _ in range(3))
    mesh_cfg = MESHES[int(rng.integers(0, len(MESHES)))]
    mesh = make_mesh(*mesh_cfg) if mesh_cfg else None
    x = rng.standard_normal(shape)
    got = offt_tpu.rfft3d(x, mesh=mesh)
    assert rel_err(got, np.fft.rfftn(x)) < 1e-11, (shape, mesh_cfg)
    back = offt_tpu.irfft3d(np.asarray(got), nz=shape[2], mesh=mesh)
    assert rel_err(back, x) < 1e-11, (shape, mesh_cfg)


SMOOTH = [8, 12, 16, 24, 32, 48, 64, 96, 128]


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_pallas_fused(trial):
    """Engine fuzz (complex64 planar, even trials on the XLA engine, odd
    ones on the matmul chain): random smooth shapes, plus a pow2 row
    stride and a long last axis."""
    from offt_tpu.plan.params import PlanParams

    pp = PlanParams(engine=("xla", "matmul")[trial % 2])
    rng = np.random.default_rng(3000 + trial)
    shape = tuple(int(SMOOTH[rng.integers(0, len(SMOOTH))]) for _ in range(3))
    if trial == 6:
        shape = (16, 128, 128)    # pow2 row stride: stride-padded x path
    if trial == 7:
        shape = (8, 16, 512)      # M=256: dual-transform untangle
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    p = offt_tpu.plan(shape, "complex64", planar=True,
                      params=pp, use_cache=False)
    yr, yi = p((x.real.copy(), x.imag.copy()))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert rel_err(got, np.fft.fftn(x)) < 1e-5, shape
    pinv = offt_tpu.plan(shape, "complex64", planar=True, inverse=True,
                         params=pp, use_cache=False)
    br, bi = pinv((yr, yi))
    assert rel_err(np.asarray(br) + 1j * np.asarray(bi), x) < 1e-5, shape
    # r2c on the same dims when eligible (even z)
    if shape[2] % 2 == 0:
        xr_ = rng.standard_normal(shape).astype(np.float32)
        pr = offt_tpu.plan(shape, "complex64", real=True, planar=True,
                           params=pp, use_cache=False)
        wr, wi = pr(xr_)
        want = np.fft.rfftn(xr_.astype(np.float64))
        assert rel_err(np.asarray(wr) + 1j * np.asarray(wi), want) < 1e-5, shape
