"""Distributed long-1-D FFT (dist/long1d.py): the four-step engine over
the mesh — natural-order in/out, three tunable exchanges, fused local
kernels. No reference analogue (its 1-D engines are local FFTW
sub-plans, setup_p1d offt-compute.c:329-489); accuracy bars are the
project conventions (1e-6 fp32 / 1e-12 fp64 vs numpy.fft)."""

import numpy as np
import pytest

import offt_tpu
from offt_tpu.dist import make_mesh
from offt_tpu.dist.long1d import dist1d_split, make_dist_fft1d
from offt_tpu.plan.api import plan
from offt_tpu.plan.params import PlanParams


def _cx(rng, n, dtype=np.complex64):
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return x.astype(dtype)


@pytest.mark.parametrize("p1,p2", [(2, 4), (1, 8), (8, 1)])
def test_dist1d_forward_matches_numpy(p1, p2):
    mesh = make_mesh(p1, p2)
    n = 4096
    x = _cx(np.random.default_rng(0), n).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh)
    assert p._shards is not None, "plan did not route to the dist-1d engine"
    got = np.asarray(p(x))[0, 0]
    want = np.fft.fft(x[0, 0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_dist1d_inverse_roundtrip_and_norms():
    mesh = make_mesh(2, 4)
    n = 4096
    x = _cx(np.random.default_rng(1), n).reshape(1, 1, n)
    for norm in (None, "ortho", "forward"):
        pf_ = plan((1, 1, n), "complex64", mesh=mesh, norm=norm)
        pi = plan((1, 1, n), "complex64", mesh=mesh, norm=norm,
                  inverse=True)
        z = np.asarray(pi(pf_(x)))[0, 0]
        err = np.linalg.norm(z - x[0, 0]) / np.linalg.norm(x[0, 0])
        assert err < 1e-6, (norm, err)


def test_dist1d_inverse_matches_numpy_ifft():
    mesh = make_mesh(2, 4)
    n = 4096
    x = _cx(np.random.default_rng(2), n).reshape(1, 1, n)
    pi = plan((1, 1, n), "complex64", mesh=mesh, inverse=True)
    got = np.asarray(pi(x))[0, 0]
    want = np.fft.ifft(x[0, 0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


@pytest.mark.parametrize("s1,s2,v", [(1, 1, 0), (0, 0, 3), (1, 0, 1)])
def test_dist1d_exchange_strategies(s1, s2, v):
    """Every (s, v) exchange-strategy combination computes the same
    spectrum (ring ppermute, gather+slice, mixed)."""
    mesh = make_mesh(2, 4)
    n = 4096
    x = _cx(np.random.default_rng(3), n).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh,
             params=PlanParams(s1=s1, s2=s2, v=v))
    got = np.asarray(p(x))[0, 0]
    want = np.fft.fft(x[0, 0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_dist1d_fused_kernels_2pow20():
    """n = 2^20 on 8 devices -> (1024, 1024) split, on the matmul
    engine (the default engine runs every other dist-1d test). x64 is
    on in this suite: complex64 must stay complex64."""
    mesh = make_mesh(2, 4)
    n = 1 << 20
    x = _cx(np.random.default_rng(4), n).reshape(1, 1, n)
    pp = PlanParams(p1=2, engine="matmul")
    p = plan((1, 1, n), "complex64", mesh=mesh, params=pp)
    got = np.asarray(p(x))[0, 0]
    want = np.fft.fft(x[0, 0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_dist1d_non_pow2():
    """Non-power-of-two length with a P-divisible split (3*2^16 on 8
    devices) rides the engine; spectrum matches numpy."""
    mesh = make_mesh(2, 4)
    n = 3 * (1 << 16)
    x = _cx(np.random.default_rng(10), n).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh)
    assert p._shards is not None
    got = np.asarray(p(x))[0, 0]
    want = np.fft.fft(x[0, 0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_dist1d_fp64():
    mesh = make_mesh(2, 4)
    n = 4096
    x = _cx(np.random.default_rng(5), n, np.complex128).reshape(1, 1, n)
    p = plan((1, 1, n), "complex128", mesh=mesh)
    got = np.asarray(p(x))[0, 0]
    want = np.fft.fft(x[0, 0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12


def test_dist1d_batch_dims():
    mesh = make_mesh(2, 4)
    n = 4096
    rng = np.random.default_rng(6)
    xb = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    xb = xb.astype(np.complex64).reshape(3, 1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh, batch_dims=1)
    got = np.asarray(p(xb))[:, 0, 0]
    want = np.fft.fft(xb[:, 0, 0], axis=-1)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_dist1d_natural_sharding_reported():
    """Input and output are BOTH flat natural order — the Plan reports
    the last-axis-over-all-devices sharding, not a pencil layout."""
    from jax.sharding import PartitionSpec as P
    mesh = make_mesh(2, 4)
    n = 4096
    p = plan((1, 1, n), "complex64", mesh=mesh)
    assert p.input_sharding.spec == P(None, None, ("row", "col"))
    assert p.output_sharding.spec == P(None, None, ("row", "col"))
    # and the executed output actually lands in that sharding
    x = _cx(np.random.default_rng(7), n).reshape(1, 1, n)
    y = p(x)
    assert y.sharding.is_equivalent_to(p.output_sharding, 3)


def test_dist1d_split_divisibility_gate():
    """dist1d_split requires P | n1 and P | n2; an explicit split_1d
    violating that falls back (plan still works, degenerate pencil)."""
    mesh = make_mesh(2, 4)
    # 2^12 with P=8: a P-divisible pair exists (the most balanced one)
    assert dist1d_split(mesh, 4096, PlanParams()) == (64, 64)
    # explicit split with n1 not divisible by 8 -> ineligible
    assert dist1d_split(mesh, 4096, PlanParams(split_1d=(4, 1024))) is None
    # prime-ish length with no valid pair -> ineligible, plan falls back
    n = 2 * 1949  # 2 * prime: no P-divisible split
    assert dist1d_split(mesh, n, PlanParams()) is None
    x = _cx(np.random.default_rng(8), n).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh)
    assert p._shards is None  # pencil fallback
    got = np.asarray(p(x))[0, 0]
    want = np.fft.fft(x[0, 0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_dist1d_golden_dc_bin():
    """DC bin = exact sum of inputs (the golden-check discipline,
    run-fft.c:46-126)."""
    mesh = make_mesh(2, 4)
    n = 4096
    x = np.arange(n, dtype=np.float64).astype(np.complex64).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh)
    got = np.asarray(p(x))[0, 0]
    dc = got[0]
    assert abs(dc - x.sum()) / abs(x.sum()) < 1e-6


def _unpack(got, n):
    """Packed (M,) -> numpy (M+1,) half-spectrum layout."""
    full = np.empty(n // 2 + 1, complex)
    full[0] = got[0].real
    full[-1] = got[0].imag
    full[1:-1] = got[1:]
    return full


@pytest.mark.parametrize("p1,p2", [(2, 4), (1, 8)])
def test_dist1d_rfft_packed_matches_numpy(p1, p2):
    """Distributed 1-D r2c (half-length c2c + distributed Hermitian
    untangle, packed layout) matches numpy.fft.rfft."""
    mesh = make_mesh(p1, p2)
    n = 8192
    x = np.random.default_rng(20).standard_normal(n).astype(
        np.float32).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh, real=True, planar=True,
             packed=True)
    assert p._shards is not None
    yr, yi = p(x)
    got = np.asarray(yr)[0, 0] + 1j * np.asarray(yi)[0, 0]
    want = np.fft.rfft(x[0, 0])
    err = np.linalg.norm(_unpack(got, n) - want) / np.linalg.norm(want)
    assert err < 1e-6


def test_dist1d_irfft_packed_roundtrip_and_norms():
    mesh = make_mesh(2, 4)
    n = 8192
    x = np.random.default_rng(21).standard_normal(n).astype(
        np.float32).reshape(1, 1, n)
    for norm in (None, "ortho"):
        pf_ = plan((1, 1, n), "complex64", mesh=mesh, real=True,
                   planar=True, packed=True, norm=norm)
        pi = plan((1, 1, n), "complex64", mesh=mesh, real=True,
                  inverse=True, planar=True, packed=True, norm=norm)
        back = np.asarray(pi(pf_(x)))[0, 0]
        err = np.linalg.norm(back - x[0, 0]) / np.linalg.norm(x[0, 0])
        assert err < 1e-6, (norm, err)


def test_dist1d_rfft_fused_long():
    """Long real transform (n = 2^21 -> half-length 2^20 rides the
    distributed four-step on 8 devices, matmul engine) + c2r
    roundtrip."""
    mesh = make_mesh(2, 4)
    n = 1 << 21
    x = np.random.default_rng(22).standard_normal(n).astype(
        np.float32).reshape(1, 1, n)
    pp = PlanParams(p1=2, engine="matmul")
    p = plan((1, 1, n), "complex64", mesh=mesh, real=True, planar=True,
             packed=True, params=pp)
    yr, yi = p(x)
    got = np.asarray(yr)[0, 0] + 1j * np.asarray(yi)[0, 0]
    want = np.fft.rfft(x[0, 0])
    err = np.linalg.norm(_unpack(got, n) - want) / np.linalg.norm(want)
    assert err < 1e-6
    pi = plan((1, 1, n), "complex64", mesh=mesh, real=True, inverse=True,
              planar=True, packed=True, params=pp)
    back = np.asarray(pi((yr, yi)))[0, 0]
    assert (np.linalg.norm(back - x[0, 0])
            / np.linalg.norm(x[0, 0])) < 1e-6


def test_dist1d_rfft_dc_and_nyquist_exact():
    """Packed bin 0: DC = sum(x), Nyquist = sum(x * (-1)^j — the golden
    anchor for the distributed untangle's boundary handling."""
    mesh = make_mesh(2, 4)
    n = 4096
    x = np.random.default_rng(23).standard_normal(n).astype(
        np.float32).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh, real=True, planar=True,
             packed=True)
    yr, yi = p(x)
    dc = float(np.asarray(yr)[0, 0, 0])
    ny = float(np.asarray(yi)[0, 0, 0])
    want_dc = float(x.sum())
    want_ny = float((x[0, 0] * (-1.0) ** np.arange(n)).sum())
    assert abs(dc - want_dc) / abs(want_dc) < 1e-5
    assert abs(ny - want_ny) / max(abs(want_ny), 1e-6) < 1e-4


def test_dist1d_rfft_autodiff_analytic():
    """grad through the distributed packed r2c plan, checked against the
    EXACT Parseval gradient of L = sum|X_packed|^2: with S = sum(x) and
    A = sum((-1)^j x_j), dL/dx_j = n*x_j + S + (-1)^j A (the packed
    layout counts DC/Nyquist once and interior bins once, so
    L = (n*sum(x^2) + S^2 + A^2)/2). Pins the adjoint's packed bin
    weighting on the distributed engine."""
    import jax
    import jax.numpy as jnp
    mesh = make_mesh(2, 4)
    n = 4096
    x = np.random.default_rng(24).standard_normal(n).astype(
        np.float32).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh, real=True, planar=True,
             packed=True)

    def loss(v):
        yr, yi = p(v)
        return jnp.sum(yr ** 2 + yi ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(x)))[0, 0]
    sgn = (-1.0) ** np.arange(n)
    want = n * x[0, 0] + x.sum() + sgn * (x[0, 0] * sgn).sum()
    assert np.linalg.norm(g - want) / np.linalg.norm(want) < 1e-5


def test_dist1d_space_candidates_are_p_divisible():
    """The tuner's split_1d dimension only offers P-divisible pairs for
    distributed specs (a non-divisible pair silently falls back to the
    single-device engine — a wasted trial)."""
    from offt_tpu.plan.params import ProblemSpec
    from offt_tpu.tune.space import _split1d_candidates
    spec = ProblemSpec(shape=(1, 1, 65536), p=8)
    cands = _split1d_candidates(spec)
    assert len(cands) > 1
    for c in cands[1:]:
        assert c[0] % 8 == 0 and c[1] % 8 == 0, c
    # single-device candidates for a locally-expressible length stay None
    spec1 = ProblemSpec(shape=(1, 1, 4096), p=1)
    assert _split1d_candidates(spec1) == (None,)
    # ... but the SAME length distributed has candidates (the dist
    # engine shards lengths one device could handle alone)
    spec8 = ProblemSpec(shape=(1, 1, 4096), p=8)
    assert len(_split1d_candidates(spec8)) > 1


def test_dist1d_autodiff():
    """grad flows through the distributed 1-D plan (native autodiff
    through the shard_map'd engine)."""
    import jax
    import jax.numpy as jnp
    mesh = make_mesh(2, 4)
    n = 4096
    x = _cx(np.random.default_rng(9), n).reshape(1, 1, n)
    p = plan((1, 1, n), "complex64", mesh=mesh, norm="ortho")

    def loss(v):
        return jnp.sum(jnp.abs(p(v)) ** 2)

    g = np.asarray(jax.grad(loss, holomorphic=False)(jnp.asarray(x)))
    # ortho FFT is unitary: d/dx* sum|Fx|^2 = (F^H F x)* ... = x (conj
    # convention) up to JAX's grad convention — check against numerical
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.abs(jnp.fft.fft(v, norm="ortho")) ** 2)
    )(jnp.asarray(x)))
    assert np.linalg.norm(g - want) / np.linalg.norm(want) < 1e-5
