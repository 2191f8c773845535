"""numpy.fft drop-in namespace (offt_tpu.fft) vs numpy.fft.

Every function of the numpy.fft surface, checked against numpy on the
same inputs — 1-D along arbitrary axes with crop/pad, the Hermitian
pair, n-D with axes subsets / out-of-order / repeated axes, and the
helper functions bit-for-bit. The reference has no such layer (its user
API is the planned offt.h surface); this is the MIGRATION.md
switching-user convenience built on cached plans."""

import numpy as np
import pytest

from offt_tpu import fft as F


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _relerr(got, want):
    got = np.asarray(got)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---- 1-D ------------------------------------------------------------------

@pytest.mark.parametrize("n_in,n_arg", [(16, None), (16, 16), (16, 9),
                                        (16, 24), (15, None), (13, None)])
def test_fft_ifft_lengths(rng, n_in, n_arg):
    x = _c64(rng, (n_in,))
    assert _relerr(F.fft(x, n=n_arg), np.fft.fft(x, n=n_arg)) < 1e-5
    assert _relerr(F.ifft(x, n=n_arg), np.fft.ifft(x, n=n_arg)) < 1e-5


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_fft_axis(rng, axis):
    x = _c64(rng, (8, 12, 16))
    assert _relerr(F.fft(x, axis=axis), np.fft.fft(x, axis=axis)) < 1e-5


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_fft_norms(rng, norm):
    x = _c64(rng, (32,))
    assert _relerr(F.fft(x, norm=norm), np.fft.fft(x, norm=norm)) < 1e-5
    assert _relerr(F.ifft(x, norm=norm), np.fft.ifft(x, norm=norm)) < 1e-5


def test_fft_real_input_promotes(rng):
    x = rng.standard_normal(16).astype(np.float32)
    y = F.fft(x)
    assert np.asarray(y).dtype == np.complex64
    assert _relerr(y, np.fft.fft(x)) < 1e-5


def test_fft_float64_x64_path(rng):
    # conftest enables x64: float64 input routes to the fp64 pipeline
    x = (rng.standard_normal(16)
         + 1j * rng.standard_normal(16)).astype(np.complex128)
    y = F.fft(x)
    assert np.asarray(y).dtype == np.complex128
    assert _relerr(y, np.fft.fft(x)) < 1e-10


@pytest.mark.parametrize("n_in,n_arg", [(16, None), (16, 10), (16, 24),
                                        (15, None)])
def test_rfft_lengths(rng, n_in, n_arg):
    x = rng.standard_normal(n_in).astype(np.float32)
    assert _relerr(F.rfft(x, n=n_arg), np.fft.rfft(x, n=n_arg)) < 1e-5


@pytest.mark.parametrize("n_out", [16, 15, 10, 24])
def test_irfft_lengths(rng, n_out):
    x = _c64(rng, (9,))
    assert _relerr(F.irfft(x, n=n_out), np.fft.irfft(x, n=n_out)) < 1e-5


def test_rfft_irfft_axis(rng):
    x = rng.standard_normal((6, 16, 4)).astype(np.float32)
    assert _relerr(F.rfft(x, axis=1), np.fft.rfft(x, axis=1)) < 1e-5
    y = np.fft.rfft(x, axis=1).astype(np.complex64)
    assert _relerr(F.irfft(y, n=16, axis=1),
                   np.fft.irfft(y, n=16, axis=1)) < 1e-5


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_hfft_ihfft(rng, norm):
    x = _c64(rng, (9,))
    assert _relerr(F.hfft(x, norm=norm), np.fft.hfft(x, norm=norm)) < 1e-5
    xr = rng.standard_normal(16).astype(np.float32)
    assert _relerr(F.ihfft(xr, norm=norm),
                   np.fft.ihfft(xr, norm=norm)) < 1e-5


# ---- 2-D / n-D ------------------------------------------------------------

def test_fft2_default_and_axes(rng):
    x = _c64(rng, (8, 16, 12))
    assert _relerr(F.fft2(x), np.fft.fft2(x)) < 1e-5
    assert _relerr(F.fft2(x, axes=(0, 1)), np.fft.fft2(x, axes=(0, 1))) < 1e-5
    assert _relerr(F.ifft2(x), np.fft.ifft2(x)) < 1e-5


def test_fftn_all_ranks(rng):
    for shape in [(32,), (8, 16), (4, 8, 16), (2, 4, 8, 16),
                  (2, 3, 4, 8, 16)]:
        x = _c64(rng, shape)
        assert _relerr(F.fftn(x), np.fft.fftn(x)) < 1e-5, shape
        assert _relerr(F.ifftn(x), np.fft.ifftn(x)) < 1e-5, shape


def test_fftn_axes_subset_and_order(rng):
    x = _c64(rng, (4, 8, 12, 16))
    for axes in [(1,), (0, 2), (3, 1), (2, 0, 3)]:
        assert _relerr(F.fftn(x, axes=axes),
                       np.fft.fftn(x, axes=axes)) < 1e-5, axes


def test_fftn_s_crop_pad(rng):
    x = _c64(rng, (8, 12))
    assert _relerr(F.fftn(x, s=(6, 16)),
                   np.fft.fftn(x, s=(6, 16), axes=(0, 1))) < 1e-5
    # s with axes=None means the LAST len(s) axes
    x3 = _c64(rng, (4, 8, 12))
    assert _relerr(F.fftn(x3, s=(8, 8)),
                   np.fft.fftn(x3, s=(8, 8), axes=(1, 2))) < 1e-5


def test_fftn_repeated_axes(rng):
    x = _c64(rng, (8, 8))
    assert _relerr(F.fftn(x, axes=(0, 0)),
                   np.fft.fftn(x, axes=(0, 0))) < 1e-5


@pytest.mark.parametrize("norm", ["ortho", "forward"])
def test_fftn_norm_composes_across_groups(rng, norm):
    # rank 5 over all axes: two plan groups; the per-group norm must
    # compose to numpy's whole-transform scaling
    x = _c64(rng, (2, 3, 4, 6, 8))
    assert _relerr(F.fftn(x, norm=norm), np.fft.fftn(x, norm=norm)) < 1e-5


def test_rfftn_ranks_and_axes(rng):
    for shape in [(16,), (8, 16), (4, 8, 16), (2, 4, 8, 16)]:
        x = rng.standard_normal(shape).astype(np.float32)
        assert _relerr(F.rfftn(x), np.fft.rfftn(x)) < 1e-5, shape
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    assert _relerr(F.rfftn(x, axes=(2, 0)),
                   np.fft.rfftn(x, axes=(2, 0))) < 1e-5


def test_irfftn_roundtrip_and_odd(rng):
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    y = np.fft.rfftn(x).astype(np.complex64)
    assert _relerr(F.irfftn(y), np.fft.irfftn(y)) < 1e-5
    assert _relerr(F.irfftn(y, s=(4, 8, 15)),
                   np.fft.irfftn(y, s=(4, 8, 15), axes=(0, 1, 2))) < 1e-5


def test_rfft2_irfft2(rng):
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    assert _relerr(F.rfft2(x), np.fft.rfft2(x)) < 1e-5
    y = np.fft.rfft2(x).astype(np.complex64)
    assert _relerr(F.irfft2(y), np.fft.irfft2(y)) < 1e-5


# ---- helpers + autodiff ---------------------------------------------------

@pytest.mark.parametrize("n", [8, 9])
def test_shift_helpers(rng, n):
    x = rng.standard_normal((n, n + 1))
    assert np.array_equal(np.asarray(F.fftshift(x)), np.fft.fftshift(x))
    assert np.array_equal(np.asarray(F.ifftshift(x)), np.fft.ifftshift(x))
    assert np.array_equal(np.asarray(F.fftshift(x, axes=1)),
                          np.fft.fftshift(x, axes=1))
    assert np.array_equal(
        np.asarray(F.ifftshift(F.fftshift(x))), x)


@pytest.mark.parametrize("n", [8, 9])
def test_freq_helpers(n):
    np.testing.assert_allclose(np.asarray(F.fftfreq(n, d=0.5)),
                               np.fft.fftfreq(n, d=0.5), atol=1e-7)
    np.testing.assert_allclose(np.asarray(F.rfftfreq(n, d=2.0)),
                               np.fft.rfftfreq(n, d=2.0), atol=1e-7)


def test_grad_through_npfft(rng):
    # the namespace rides differentiable plans
    import jax
    import jax.numpy as jnp

    x = rng.standard_normal((8, 16)).astype(np.float32)

    def loss(v):
        return jnp.sum(jnp.abs(F.rfft(v)) ** 2)

    g = jax.grad(loss)(x)
    # Parseval: d/dx sum|rfft(x)|^2 = 2*N*x adjusted for the half-spectrum
    # fold; just check it is finite and matches numerical diff on one entry
    assert np.all(np.isfinite(np.asarray(g)))
    eps = 1e-3
    xp = x.copy()
    xp[3, 5] += eps
    num = (float(loss(xp)) - float(loss(x))) / eps
    assert abs(num - float(g[3, 5])) / max(abs(num), 1e-6) < 5e-2


def test_use_mesh_routes_distributed(rng):
    """offt_tpu.fft.use_mesh: numpy one-liners run distributed — 1-D
    rides the dist-1d engine, n-D the pencil pipeline; the context
    restores single-device routing on exit."""
    from offt_tpu.dist import make_mesh

    x = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    c = (rng.standard_normal((16, 16, 16))
         + 1j * rng.standard_normal((16, 16, 16))).astype(np.complex64)
    mesh = make_mesh(2, 4)
    with F.use_mesh(mesh):
        # the cached plan must actually be a distributed one
        p = F._plan_cached((1, 1, 4096), "complex64", False, False,
                           None, 0)
        assert p.mesh is mesh and p._shards is not None
        got1 = np.asarray(F.fft(x))
        rt = np.asarray(F.ifft(F.fft(x, norm="ortho"), norm="ortho"))
        got3 = np.asarray(F.fftn(c))
    w1 = np.fft.fft(x)
    assert np.linalg.norm(got1 - w1) / np.linalg.norm(w1) < 1e-6
    assert np.linalg.norm(rt - x) / np.linalg.norm(x) < 1e-6
    w3 = np.fft.fftn(c)
    assert np.linalg.norm(got3 - w3) / np.linalg.norm(w3) < 1e-6
    # context exit restores the single-device default
    assert F._MESH is None
    p0 = F._plan_cached((1, 1, 4096), "complex64", False, False, None, 0)
    assert p0.mesh is None


def test_use_mesh_sticky_setter(rng):
    from offt_tpu.dist import make_mesh

    x = (rng.standard_normal(1024)
         + 1j * rng.standard_normal(1024)).astype(np.complex64)
    F.use_mesh(make_mesh(1, 8))
    try:
        got = np.asarray(F.fft(x))
        w = np.fft.fft(x)
        assert np.linalg.norm(got - w) / np.linalg.norm(w) < 1e-6
    finally:
        F.use_mesh(None)
    assert F._MESH is None
