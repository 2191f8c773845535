"""The local transform engines through ``plan()`` against numpy.

Both engines — ``"xla"`` (jnp.fft; cuFFT on the GPU) and ``"matmul"``
(the mixed-radix matmul chain) — must meet the same bars against numpy's
float64 FFT: relative L2 error <= 1e-6 for complex64/float32 and <= 1e-12
for complex128. Cases: 1-D lengths from 8 to 2^16 and primes (Bluestein
on the matmul engine), each axis of a 3-D array, non-cubic and odd 3-D
shapes, r2c/c2r in the numpy and packed layouts, the three norms, fp64,
plus the packed-layout helpers and native forward/reverse autodiff.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import offt_tpu
from offt_tpu.kernels.rfft import (pack_last, pack_rfft3d, unpack_3d,
                                   unpack_last, unpack_rfft3d)
from offt_tpu.plan.params import PlanParams

ENGINES = ("xla", "matmul")
TOL = {np.complex64: 1e-6, np.complex128: 1e-12}


def _rel(got, want):
    got = np.asarray(got)
    return np.linalg.norm((got - want).ravel()) / np.linalg.norm(want.ravel())


def _randc(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _randr(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _plan(shape, engine, dtype="complex64", **kw):
    return offt_tpu.plan(shape, dtype, params=PlanParams(engine=engine),
                         use_cache=False, **kw)


def _ref(x, inverse, axes=(-3, -2, -1), norm=None):
    x = x.astype(np.complex128)
    return (np.fft.ifftn if inverse else np.fft.fftn)(x, axes=axes,
                                                      norm=norm)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256, 1 << 15, 1 << 16,
                               101, 10007])
def test_1d_lengths(n, engine, inverse):
    x = _randc((2, 1, 1, n), n)
    p = _plan((1, 1, n), engine, inverse=inverse, batch_dims=1)
    assert _rel(p(x), _ref(x, inverse)) < TOL[np.complex64]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_each_axis_of_3d(axis, engine, inverse):
    """A transform along one axis of a 3-D array: the other two are 1."""
    shape = [1, 1, 1]
    shape[axis] = 64
    x = _randc((3,) + tuple(shape), 10 + axis)
    p = _plan(tuple(shape), engine, inverse=inverse, batch_dims=1)
    assert _rel(p(x), _ref(x, inverse)) < TOL[np.complex64]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(8, 16, 32), (12, 10, 6), (7, 9, 11),
                                   (5, 16, 3), (32, 8, 4)])
def test_3d_shapes(shape, engine, inverse):
    x = _randc(shape, sum(shape))
    p = _plan(shape, engine, inverse=inverse)
    assert _rel(p(x), _ref(x, inverse)) < TOL[np.complex64]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(8, 8, 16), (6, 10, 12), (4, 4, 64)])
def test_r2c(shape, engine, packed):
    x = _randr(shape, 20)
    want = np.fft.rfftn(x.astype(np.float64))
    p = _plan(shape, engine, "float32", real=True, planar=True,
              packed=packed)
    yr, yi = p(x)
    if packed:
        yr, yi = unpack_rfft3d(yr, yi)
    assert _rel(np.asarray(yr) + 1j * np.asarray(yi), want) < 1e-6


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(8, 8, 16), (6, 10, 12), (4, 4, 64)])
def test_c2r(shape, engine, packed):
    x = _randr(shape, 21)
    spec = np.fft.rfftn(x.astype(np.float64))
    sr, si = spec.real.astype(np.float32), spec.imag.astype(np.float32)
    if packed:
        sr, si = pack_rfft3d(sr, si)
    p = _plan(shape, engine, "float32", real=True, inverse=True,
              planar=True, packed=packed)
    assert _rel(p(sr, si), x.astype(np.float64)) < 1e-6


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_real_odd_nz(engine, inverse):
    """Odd Nz: the numpy layout (packed needs an even Nz)."""
    shape = (8, 6, 9)
    x = _randr(shape, 22)
    spec = np.fft.rfftn(x.astype(np.float64))
    if not inverse:
        got = _plan(shape, engine, "float32", real=True)(x)
        assert _rel(got, spec) < 1e-6
    else:
        p = _plan(shape, engine, "complex64", real=True, inverse=True)
        assert _rel(p(spec.astype(np.complex64)), x) < 1e-6


def test_packed_needs_even_nz():
    with pytest.raises(ValueError, match="even Nz"):
        offt_tpu.plan((4, 4, 9), "float32", real=True, planar=True,
                      packed=True)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_norms_c2c(norm, engine):
    shape = (8, 4, 16)
    x = _randc(shape, 30)
    for inverse in (False, True):
        p = _plan(shape, engine, inverse=inverse, norm=norm)
        assert _rel(p(x), _ref(x, inverse, norm=norm)) < 1e-6


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_norms_real(norm, engine):
    shape = (4, 8, 16)
    x = _randr(shape, 31)
    want = np.fft.rfftn(x.astype(np.float64), norm=norm)
    got = _plan(shape, engine, "float32", real=True, norm=norm)(x)
    assert _rel(got, want) < 1e-6
    back = _plan(shape, engine, "complex64", real=True, inverse=True,
                 norm=norm)(want.astype(np.complex64))
    assert _rel(back, x.astype(np.float64)) < 1e-6


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 10, 14), (1, 1, 1000)])
def test_complex128(shape, engine, inverse):
    x = _randc(shape, 40, np.complex128)
    p = _plan(shape, engine, "complex128", inverse=inverse)
    assert p(x).dtype == jnp.complex128
    assert _rel(p(x), _ref(x, inverse)) < TOL[np.complex128]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_2d_planes(engine, inverse):
    x = _randc((3, 32, 48), 50)
    fn = offt_tpu.ifft2d if inverse else offt_tpu.fft2d
    got = fn(x, params=PlanParams(engine=engine))
    want = (np.fft.ifft2 if inverse else np.fft.fft2)(
        x.astype(np.complex128), axes=(-2, -1))
    assert _rel(got, want) < 1e-6


# ---- packed layout helpers -------------------------------------------------

def test_pack_unpack_3d_roundtrip():
    x = _randr((2, 6, 8, 16), 60, np.float64)
    y = np.fft.rfftn(x, axes=(-3, -2, -1))
    pr, pi = pack_rfft3d(y.real, y.imag)
    assert pr.shape == (2, 6, 8, 8)
    # bin 0 carries bin0 + i*binM
    np.testing.assert_allclose(
        np.asarray(pr[..., 0]) + 1j * np.asarray(pi[..., 0]),
        y[..., 0] + 1j * y[..., 8], rtol=1e-12, atol=1e-9)
    ur, ui = unpack_rfft3d(pr, pi)
    assert _rel(np.asarray(ur) + 1j * np.asarray(ui), y) < 1e-13


def test_unpack_pack_3d_roundtrip_complex():
    """unpack_3d recovers both Hermitian planes from any packed array
    whose planes come from real data."""
    x = _randr((4, 6, 10), 61, np.float64)
    y = np.fft.rfftn(x)
    packed = pack_last(jnp.asarray(y))
    assert _rel(unpack_3d(packed), y) < 1e-13
    assert _rel(pack_last(unpack_3d(packed)), np.asarray(packed)) < 1e-13


def test_pack_unpack_last_1d():
    """The per-pencil form used by the distributed z-stage: 1-D spectra
    of real data have real bin 0 and bin M."""
    x = _randr((5, 32), 62, np.float64)
    y = np.fft.rfft(x)
    p = pack_last(jnp.asarray(y))
    assert p.shape == (5, 16)
    assert _rel(unpack_last(p), y) < 1e-14


# ---- native autodiff through both engines ----------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_jvp_c2c_is_the_map(engine):
    p = _plan((8, 8, 8), engine)
    x = jnp.asarray(_randc((8, 8, 8), 70))
    t = jnp.asarray(_randc((8, 8, 8), 71))
    y, dy = jax.jvp(p, (x,), (t,))
    assert _rel(dy, np.fft.fftn(np.asarray(t))) < 1e-6
    assert _rel(y, np.fft.fftn(np.asarray(x))) < 1e-6


@pytest.mark.parametrize("engine", ENGINES)
def test_vjp_c2c_parseval(engine):
    """grad sum |F x|^2 = 2 N conj(x) under JAX's complex convention."""
    p = _plan((8, 4, 16), engine)
    x = jnp.asarray(_randc((8, 4, 16), 72))
    g = jax.grad(lambda v: jnp.sum(jnp.abs(p(v)) ** 2))(x)
    assert _rel(g, 2 * 512 * np.conj(np.asarray(x))) < 1e-6


@pytest.mark.parametrize("engine", ENGINES)
def test_grad_real_spectral_loss(engine):
    """L(x) = sum w |rfftn x|^2 through a real plan against jnp.fft."""
    shape = (4, 8, 16)
    x = jnp.asarray(_randr(shape, 73))
    w = jnp.asarray(np.random.default_rng(74).random((4, 8, 9)),
                    jnp.float32)
    p = _plan(shape, engine, "float32", real=True)
    g = jax.grad(lambda v: jnp.sum(w * jnp.abs(p(v)) ** 2))(x)
    want = jax.grad(lambda v: jnp.sum(w * jnp.abs(jnp.fft.rfftn(v)) ** 2))(x)
    assert _rel(g, np.asarray(want)) < 1e-5
