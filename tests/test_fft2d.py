"""2-D transforms: single-device fused slab + distributed (1, p) mesh
(the METHOD-ONE analogue — 1-D decomposition where the degenerate x axis
makes phase 2's exchange trivial, offt-compute.c:3896-3950)."""

import numpy as np
import pytest

import offt_tpu
from offt_tpu.dist import make_mesh


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _relerr(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_fft2d_single(rng):
    x = (rng.standard_normal((64, 64))
         + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    y = offt_tpu.fft2d(x)
    assert _relerr(np.asarray(y), np.fft.fft2(x)) < 1e-5
    back = offt_tpu.ifft2d(y)
    assert _relerr(np.asarray(back), x) < 1e-5


def test_fft2d_batched(rng):
    x = (rng.standard_normal((3, 32, 32))
         + 1j * rng.standard_normal((3, 32, 32))).astype(np.complex64)
    y = offt_tpu.fft2d(x)
    assert _relerr(np.asarray(y), np.fft.fft2(x, axes=(-2, -1))) < 1e-5


@pytest.mark.parametrize("p", [4, 8])
def test_fft2d_distributed(rng, p):
    x = (rng.standard_normal((64, 64))
         + 1j * rng.standard_normal((64, 64))).astype(np.complex64)
    mesh = make_mesh(1, p)
    y = offt_tpu.fft2d(x, mesh=mesh)
    assert _relerr(np.asarray(y), np.fft.fft2(x)) < 1e-5
    back = offt_tpu.ifft2d(np.asarray(y), mesh=mesh)
    assert _relerr(np.asarray(back), x) < 1e-5


def test_fft2d_distributed_uneven(rng):
    # y = 72 does not divide the 8-way COL axis: padded static shards
    x = (rng.standard_normal((72, 64))
         + 1j * rng.standard_normal((72, 64))).astype(np.complex64)
    y = offt_tpu.fft2d(x, mesh=make_mesh(1, 8))
    assert _relerr(np.asarray(y), np.fft.fft2(x)) < 1e-5


def test_rfft2d_roundtrip(rng):
    x = rng.standard_normal((64, 64)).astype(np.float32)
    y = offt_tpu.rfft2d(x)
    assert y.shape == (64, 33)
    assert _relerr(np.asarray(y), np.fft.rfft2(x)) < 1e-5
    back = offt_tpu.irfft2d(np.asarray(y))
    assert back.shape == (64, 64)
    assert _relerr(np.asarray(back), x) < 1e-5


def test_rfft2d_distributed(rng):
    x = rng.standard_normal((64, 64)).astype(np.float32)
    mesh = make_mesh(1, 4)
    y = offt_tpu.rfft2d(x, mesh=mesh)
    assert _relerr(np.asarray(y), np.fft.rfft2(x)) < 1e-5
    back = offt_tpu.irfft2d(np.asarray(y), mesh=mesh)
    assert _relerr(np.asarray(back), x) < 1e-5
