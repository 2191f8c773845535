"""Distributed pencil/slab 3-D FFT on a virtual 8-device CPU mesh
(BASELINE config 3 scaled down; the multi-device story of SURVEY.md §4)."""

import numpy as np
import pytest

import offt_tpu
from offt_tpu.dist import make_mesh
from offt_tpu.plan.params import TRANSPOSE_PPERMUTE, PlanParams


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a.ravel() - b.ravel()) / max(np.linalg.norm(b.ravel()), 1e-30)


def rand_c(shape, dtype=np.complex128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


MESHES = [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (1, 1)]


@pytest.mark.parametrize("p1,p2", MESHES)
def test_pencil_c2c(p1, p2):
    mesh = make_mesh(p1, p2)
    x = rand_c((16, 16, 16), seed=p1 * 10 + p2)
    got = offt_tpu.fft3d(x, mesh=mesh)
    want = np.fft.fftn(x)
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("p1,p2", [(2, 4), (4, 2)])
def test_pencil_ifft(p1, p2):
    mesh = make_mesh(p1, p2)
    x = rand_c((16, 16, 8), seed=5)
    got = offt_tpu.ifft3d(x, mesh=mesh)
    want = np.fft.ifftn(x)
    assert rel_err(got, want) < 1e-12


def test_pencil_roundtrip():
    mesh = make_mesh(2, 4)
    x = rand_c((16, 16, 16), seed=9)
    rt = offt_tpu.ifft3d(offt_tpu.fft3d(x, mesh=mesh), mesh=mesh)
    assert rel_err(rt, x) < 1e-12


@pytest.mark.parametrize("p1,p2", [(2, 4), (1, 8), (8, 1)])
def test_pencil_rfft(p1, p2):
    mesh = make_mesh(p1, p2)
    x = np.random.default_rng(3).standard_normal((16, 16, 16))
    got = offt_tpu.rfft3d(x, mesh=mesh)
    want = np.fft.rfftn(x)
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("p1,p2", [(2, 4), (2, 2)])
def test_pencil_irfft(p1, p2):
    mesh = make_mesh(p1, p2)
    x = np.random.default_rng(4).standard_normal((16, 16, 16))
    xf = np.fft.rfftn(x)
    got = offt_tpu.irfft3d(xf.astype(np.complex128), nz=16, mesh=mesh)
    assert rel_err(got, x) < 1e-12


@pytest.mark.parametrize("t1,t2,w", [(2, 2, 1), (4, 1, 2), (1, 4, 2), (3, 3, 1)])
def test_pipeline_chunking(t1, t2, w):
    mesh = make_mesh(2, 4)
    x = rand_c((16, 16, 16), seed=t1 * 10 + t2)
    params = PlanParams(p1=2, t1=t1, t2=t2, w1=min(w, t1), w2=min(w, t2))
    got = offt_tpu.fft3d(x, mesh=mesh, params=params)
    assert rel_err(got, np.fft.fftn(x)) < 1e-12


@pytest.mark.parametrize("ry", [0, 3, 5, 10])
def test_ry_split(ry):
    mesh = make_mesh(2, 4)
    x = rand_c((16, 16, 16), seed=ry)
    params = PlanParams(p1=2, t1=2, t2=2, ry=ry)
    got = offt_tpu.fft3d(x, mesh=mesh, params=params)
    assert rel_err(got, np.fft.fftn(x)) < 1e-12


@pytest.mark.parametrize("s1,s2", [(1, 0), (0, 1), (1, 1)])
def test_ppermute_ring_transpose(s1, s2):
    mesh = make_mesh(2, 4)
    x = rand_c((16, 16, 16), seed=s1 * 2 + s2)
    params = PlanParams(p1=2, s1=s1, s2=s2)
    got = offt_tpu.fft3d(x, mesh=mesh, params=params)
    assert rel_err(got, np.fft.fftn(x)) < 1e-12


def test_ppermute_matches_a2a():
    mesh = make_mesh(2, 4)
    x = rand_c((16, 16, 16), seed=11)
    a = offt_tpu.fft3d(x, mesh=mesh, params=PlanParams(p1=2, s1=0, s2=0))
    b = offt_tpu.fft3d(x, mesh=mesh,
                       params=PlanParams(p1=2, s1=TRANSPOSE_PPERMUTE,
                                         s2=TRANSPOSE_PPERMUTE))
    assert rel_err(a, b) < 1e-13


def test_batched_pencil():
    mesh = make_mesh(2, 4)
    x = rand_c((3, 16, 16, 16), seed=13)
    got = offt_tpu.fft3d(x, mesh=mesh)
    want = np.fft.fftn(x, axes=(-3, -2, -1))
    assert rel_err(got, want) < 1e-12


def test_output_sharding_is_transposed():
    mesh = make_mesh(2, 4)
    x = rand_c((16, 16, 16), seed=15)
    p = offt_tpu.plan((16, 16, 16), x.dtype, mesh=mesh)
    y = p(x)
    from jax.sharding import PartitionSpec as P
    assert y.sharding.spec == P(None, "row", "col")


@pytest.mark.parametrize("shape", [(9, 16, 16), (16, 12, 16), (10, 15, 14),
                                   (17, 13, 11)])
def test_uneven_shapes_padded(shape):
    """Any shape on any mesh via padded static shards (the reference's
    A2AV uneven-division capability, offt.h:109-125)."""
    mesh = make_mesh(2, 4)
    x = rand_c(shape, seed=sum(shape))
    got = offt_tpu.fft3d(x, mesh=mesh)
    assert rel_err(got, np.fft.fftn(x)) < 1e-11
    back = offt_tpu.ifft3d(np.asarray(got), mesh=mesh)
    assert rel_err(back, x) < 1e-11


def test_uneven_rfft():
    mesh = make_mesh(2, 4)
    x = np.random.default_rng(8).standard_normal((10, 12, 15))
    got = offt_tpu.rfft3d(x, mesh=mesh)
    assert rel_err(got, np.fft.rfftn(x)) < 1e-11
    back = offt_tpu.irfft3d(np.asarray(got), nz=15, mesh=mesh)
    assert rel_err(back, x) < 1e-11


def test_nonsquare_dims():
    mesh = make_mesh(2, 4)
    x = rand_c((8, 16, 32), seed=17)
    got = offt_tpu.fft3d(x, mesh=mesh)
    assert rel_err(got, np.fft.fftn(x)) < 1e-12


def test_batch_sharded_plan():
    """Zero-collective batched mode: batch axis over the whole mesh."""
    mesh = make_mesh(2, 4)
    x = rand_c((8, 16, 16, 16), np.complex64, seed=21)
    p = offt_tpu.plan((16, 16, 16), "complex64", mesh=mesh, batch_dims=1,
                      batch_sharded=True)
    y = p(x)
    want = np.fft.fftn(x, axes=(-3, -2, -1))
    assert rel_err(y, want) < 1e-5
    from jax.sharding import PartitionSpec as P
    assert y.sharding.spec[0] == ("row", "col")
    # inverse roundtrip in the same mode
    pi = offt_tpu.plan((16, 16, 16), "complex64", mesh=mesh, batch_dims=1,
                       batch_sharded=True, inverse=True)
    rt = pi(np.asarray(y))
    assert rel_err(rt, x) < 1e-5


def test_batch_sharded_requires_mesh():
    import pytest as _pytest
    with _pytest.raises(ValueError):
        offt_tpu.plan((16, 16, 16), "complex64", batch_sharded=True)


@pytest.mark.parametrize("v", [1, 2, 3])
def test_allgather_variant_matches_a2a(v):
    """The v knob (per-phase exchange primitive: all_gather+slice vs
    all_to_all) must not change results — reference V parity (offt.h:96)."""
    mesh = make_mesh(2, 4)
    x = rand_c((16, 16, 16), seed=v)
    base = offt_tpu.fft3d(x, mesh=mesh, params=PlanParams(p1=2, t1=2, t2=2))
    got = offt_tpu.fft3d(x, mesh=mesh,
                         params=PlanParams(p1=2, t1=2, t2=2, v=v))
    assert rel_err(got, base) < 1e-13


def test_allgather_variant_uneven():
    mesh = make_mesh(2, 4)
    x = rand_c((12, 10, 9), seed=7)
    got = offt_tpu.fft3d(x, mesh=mesh, params=PlanParams(p1=2, v=3))
    assert rel_err(got, np.fft.fftn(x)) < 1e-12


def test_multislice_mesh_batched():
    """Multi-slice (DCN) story: a (slice, p1, p2) mesh shards the batch
    axis over the slow DCN axis while the pencil all_to_alls stay within
    each slice's ICI (SURVEY §5 comm backend; VERDICT r1 item 10)."""
    from offt_tpu.dist.mesh import SLICE, make_multislice_mesh

    mesh = make_multislice_mesh(2, 2, 2)          # 2 slices x (2,2) chips
    assert mesh.axis_names == (SLICE, "row", "col")
    x = rand_c((4, 16, 16, 16), dtype=np.complex64, seed=11)
    got = offt_tpu.fft3d(x, mesh=mesh)
    want = np.fft.fftn(x, axes=(-3, -2, -1))
    assert rel_err(got, want) < 1e-5
    # inverse roundtrip over the same nested mesh
    back = offt_tpu.ifft3d(np.asarray(got), mesh=mesh)
    assert rel_err(back, x) < 1e-5


def test_multislice_requires_batch():
    from offt_tpu.dist.mesh import make_multislice_mesh

    mesh = make_multislice_mesh(2, 2, 2)
    x = rand_c((16, 16, 16), dtype=np.complex64, seed=12)
    with pytest.raises(ValueError, match="batch"):
        offt_tpu.fft3d(x, mesh=mesh)


def test_distributed_packed_rfft():
    """Distributed packed r2c: the frequency axis stays at M = Nz/2
    aligned lanes through both exchanges (no Nyquist padding) and the
    roundtrip with the packed c2r plan is exact."""
    from offt_tpu.kernels.rfft import unpack_rfft3d

    mesh = make_mesh(2, 4)
    shape = (16, 16, 32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    fwd = offt_tpu.plan(shape, "complex64", mesh=mesh, real=True,
                        planar=True, packed=True)
    yr, yi = fwd(x)
    assert yr.shape == (16, 16, 16)          # M = 16 packed lanes
    ur, ui = unpack_rfft3d(np.asarray(yr), np.asarray(yi))
    got = np.asarray(ur) + 1j * np.asarray(ui)
    want = np.fft.rfftn(x.astype(np.float64))
    assert rel_err(got, want) < 1e-5
    inv = offt_tpu.plan(shape, "complex64", mesh=mesh, real=True,
                        inverse=True, planar=True, packed=True)
    back = inv((yr, yi))
    assert rel_err(np.asarray(back), x) < 1e-5
