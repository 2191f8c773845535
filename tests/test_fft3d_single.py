"""Single-device 3-D plans (BASELINE config 2: 256^3 slab/local)."""

import numpy as np
import pytest

import offt_tpu
from offt_tpu.plan.params import PlanParams


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a.ravel() - b.ravel()) / max(np.linalg.norm(b.ravel()), 1e-30)


def rand_c(shape, dtype=np.complex128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 8, 4), (12, 10, 6), (32, 32, 32)])
def test_fft3d_local(shape):
    x = rand_c(shape)
    got = offt_tpu.fft3d(x)
    want = np.fft.fftn(x)
    assert rel_err(got, want) < 1e-12


def test_fft3d_local_fp32_256():
    x = rand_c((64, 64, 64), np.complex64, seed=3)
    got = offt_tpu.fft3d(x)
    want = np.fft.fftn(x)
    assert rel_err(got, want) < 1e-6


def test_ifft3d_local():
    x = rand_c((16, 12, 8))
    got = offt_tpu.ifft3d(x)
    want = np.fft.ifftn(x)
    assert rel_err(got, want) < 1e-12
    rt = offt_tpu.ifft3d(offt_tpu.fft3d(x))
    assert rel_err(rt, x) < 1e-12


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 12, 10), (8, 8, 7)])
def test_rfft3d_local(shape):
    x = np.random.default_rng(1).standard_normal(shape)
    got = offt_tpu.rfft3d(x)
    want = np.fft.rfftn(x)
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 12, 10), (8, 8, 7)])
def test_irfft3d_local(shape):
    x = np.random.default_rng(2).standard_normal(shape)
    xf = np.fft.rfftn(x)
    got = offt_tpu.irfft3d(xf, nz=shape[2])
    assert rel_err(got, x) < 1e-12


def test_batched_local():
    x = rand_c((4, 8, 8, 8))
    got = offt_tpu.fft3d(x)
    want = np.fft.fftn(x, axes=(-3, -2, -1))
    assert rel_err(got, want) < 1e-12


def test_radix_override_plan():
    x = rand_c((16, 16, 16))
    p = offt_tpu.plan((16, 16, 16), x.dtype,
                      params=PlanParams(engine="matmul", radix_z=(4, 4),
                                        radix_y=(2, 8), radix_x=(16,)))
    assert rel_err(p(x), np.fft.fftn(x)) < 1e-12


def test_plan_objects():
    p = offt_tpu.plan((8, 8, 8), "complex64")
    x = rand_c((8, 8, 8), np.complex64)
    y1 = p(x)
    y2 = p.execute(x)
    assert rel_err(y1, y2) == 0


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_norm_conventions(norm):
    x = rand_c((8, 8, 8), np.complex128, seed=42)
    p = offt_tpu.plan((8, 8, 8), x.dtype, norm=norm)
    got = np.asarray(p(x))
    want = np.fft.fftn(x, norm=norm)
    assert rel_err(got, want) < 1e-12
    pi = offt_tpu.plan((8, 8, 8), x.dtype, inverse=True, norm=norm)
    got_i = np.asarray(pi(x))
    want_i = np.fft.ifftn(x, norm=norm)
    assert rel_err(got_i, want_i) < 1e-12
    # roundtrip is identity for every convention
    rt = np.asarray(pi(np.asarray(p(x))))
    assert rel_err(rt, x) < 1e-12


def test_norm_invalid():
    with pytest.raises(ValueError):
        offt_tpu.plan((8, 8, 8), "complex64", norm="bogus")


def test_fft2d():
    x = rand_c((4, 32, 64), np.complex128, seed=33)
    got = np.asarray(offt_tpu.fft2d(x))
    want = np.fft.fft2(x, axes=(-2, -1))
    assert rel_err(got, want) < 1e-12
    rt = np.asarray(offt_tpu.ifft2d(got))
    assert rel_err(rt, x) < 1e-12
    # plain 2-D array too
    y = rand_c((16, 16), np.complex128, seed=34)
    assert rel_err(offt_tpu.fft2d(y), np.fft.fft2(y)) < 1e-12
