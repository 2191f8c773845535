"""Long 1-D transforms (BASELINE config 1) and the four-step split.

The reference handles arbitrary 1-D lengths with FFTW sub-plans
(setup_p1d, offt-compute.c:329-489). Here a degenerate (1, 1, N) plan
runs N directly on the local engine on one device, and the (n1, n2)
four-step factorization across a mesh (dist/long1d.py). These tests pin
the split picker, accuracy against numpy on both engines in both
directions and all norms, the split_1d knob's feasibility rules, and its
SearchSpace dimension.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from offt_tpu.dist import make_mesh
from offt_tpu.dist.long1d import pick_split
from offt_tpu.plan import plan
from offt_tpu.plan.params import PlanParams, ProblemSpec, infeasible_reason
from offt_tpu.tune.space import build_space

TOL = 2e-6  # fp32 bar: max-abs error relative to the largest output
ENGINES = ("xla", "matmul")


def _rand_c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    a = np.asarray(a)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------- pick_split

def test_pick_split_auto_valid():
    for n, div in ((1 << 15, 1), (1 << 16, 8), (1 << 20, 4),
                   (3 * (1 << 13), 8)):
        n1, n2 = pick_split(n, divisor=div)
        assert n1 * n2 == n and n1 % div == 0 and n2 % div == 0
        assert n1 <= n2          # most balanced pair, small factor first
    assert pick_split(1 << 20) == (1024, 1024)


def test_pick_split_explicit_validated():
    assert pick_split(1 << 16, (256, 256)) == (256, 256)
    assert pick_split(1 << 16, (3, 100)) is None       # wrong product
    assert pick_split(1 << 16, (2, 1 << 15)) == (2, 1 << 15)
    assert pick_split(1 << 16, (2, 1 << 15), divisor=4) is None
    assert pick_split(7, None) is None                 # prime


# ---------------------------------------------------------------- numerics

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_matches_numpy(n, inverse, engine):
    rng = np.random.default_rng(7)
    x = _rand_c64(rng, (3, 1, 1, n))
    p = plan((1, 1, n), batch_dims=1, inverse=inverse, use_cache=False,
             params=PlanParams(engine=engine))
    ref = (np.fft.ifft if inverse else np.fft.fft)(x, axis=-1)
    assert _rel(p(x), ref) < TOL


def test_four_step_nonpow2():
    n = 3 * (1 << 13)  # 24576
    mesh = make_mesh(2, 4)
    assert pick_split(n, divisor=8) is not None
    rng = np.random.default_rng(8)
    x = _rand_c64(rng, (1, 1, n))
    p = plan((1, 1, n), mesh=mesh, use_cache=False)
    assert p._shards is not None
    assert _rel(np.asarray(p(x)).ravel(), np.fft.fft(x.ravel())) < TOL


def test_four_step_out_scale_folds():
    """The norm's output scale folds into the distributed twiddle."""
    n = 1 << 15
    rng = np.random.default_rng(9)
    x = _rand_c64(rng, (1, 1, n))
    p = plan((1, 1, n), mesh=make_mesh(2, 4), norm="forward",
             use_cache=False)
    assert _rel(np.asarray(p(x)).ravel(), np.fft.fft(x.ravel()) / n) < TOL


def test_four_step_explicit_split_same_answer():
    n = 1 << 16
    mesh = make_mesh(2, 4)
    rng = np.random.default_rng(10)
    x = _rand_c64(rng, (1, 1, n))
    a = plan((1, 1, n), mesh=mesh, use_cache=False)(x)
    b = plan((1, 1, n), mesh=mesh, use_cache=False,
             params=PlanParams(p1=2, split_1d=(128, 512)))(x)
    ref = np.fft.fft(x.ravel())
    assert _rel(np.asarray(a).ravel(), ref) < TOL
    assert _rel(np.asarray(b).ravel(), ref) < TOL


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_plan_long_1d_route(norm):
    """A degenerate (1, 1, N) plan matches numpy under every norm, on one
    device and through the distributed engine."""
    n = 1 << 15
    rng = np.random.default_rng(11)
    x = _rand_c64(rng, (1, 1, n))
    ref = np.fft.fft(x.ravel(), norm=norm or "backward")
    for mesh in (None, make_mesh(2, 4)):
        p = plan((1, 1, n), norm=norm, mesh=mesh, use_cache=False)
        assert _rel(np.asarray(p(x)).ravel(), ref) < TOL


def test_plan_long_1d_inverse():
    n = 1 << 15
    rng = np.random.default_rng(12)
    x = _rand_c64(rng, (1, 1, n))
    for engine in ENGINES:
        p = plan((1, 1, n), params=PlanParams(engine=engine), inverse=True,
                 use_cache=False)
        assert _rel(np.asarray(p(x)).ravel(), np.fft.ifft(x.ravel())) < TOL


def test_plan_split_knob_changes_nothing_numerically():
    n = 1 << 15
    mesh = make_mesh(2, 4)
    rng = np.random.default_rng(13)
    x = _rand_c64(rng, (1, 1, n))
    pa = plan((1, 1, n), mesh=mesh, use_cache=False)
    pb = plan((1, 1, n), mesh=mesh, use_cache=False,
              params=pa.params.replace(split_1d=(256, 128)))
    ref = np.fft.fft(x.ravel())
    assert _rel(np.asarray(pa(x)).ravel(), ref) < TOL
    assert _rel(np.asarray(pb(x)).ravel(), ref) < TOL


def test_plan_long_1d_grad():
    """Native autodiff through a long 1-D plan."""
    n = 1 << 15
    rng = np.random.default_rng(14)
    x = _rand_c64(rng, (1, 1, n))
    p = plan((1, 1, n), use_cache=False)

    def loss(v):
        y = p(v)
        return jnp.sum(jnp.abs(y) ** 2)

    g = np.asarray(jax.grad(loss, holomorphic=False)(jnp.asarray(x)))
    # Parseval (jax.grad convention: conj of the Wirtinger cogradient):
    # grad sum |F x|^2 = 2 N conj(x) under the backward norm
    assert _rel(g, 2.0 * n * np.conj(x)) < 5e-6


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", [101, 10007])
def test_plan_prime_bluestein_fused_inner(n, engine):
    """Prime lengths: XLA's FFT takes them directly; the matmul engine
    runs Bluestein's chirp-z (stockham._bluestein_last)."""
    rng = np.random.default_rng(16)
    x = _rand_c64(rng, (1, 1, n))
    pp = PlanParams(engine=engine)
    p = plan((1, 1, n), params=pp, use_cache=False)
    assert _rel(np.asarray(p(x)).ravel(), np.fft.fft(x.ravel())) < TOL
    pi = plan((1, 1, n), params=pp, inverse=True, use_cache=False)
    assert _rel(np.asarray(pi(x)).ravel(), np.fft.ifft(x.ravel())) < TOL


def test_plan_long_1d_rfft_irfft():
    n = 1 << 16
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, 1, n)).astype(np.float32)
    p = plan((1, 1, n), real=True, use_cache=False)
    y = np.asarray(p(x)).ravel()
    ref = np.fft.rfft(x.ravel())
    assert _rel(y, ref) < TOL
    pi = plan((1, 1, n), real=True, inverse=True, use_cache=False)
    z = np.asarray(pi(ref.reshape(1, 1, -1).astype(np.complex64))).ravel()
    assert _rel(z, np.fft.irfft(ref, n)) < TOL


# ---------------------------------------------------------------- knob rules

def _spec(shape, real=False, p=1):
    return ProblemSpec(shape=shape, dtype="complex64", real=real,
                       inverse=False, p=p)


def test_split1d_feasibility():
    ok = PlanParams(split_1d=(256, 128))
    assert infeasible_reason(_spec((1, 1, 1 << 15)), ok) is None
    bad_shape = infeasible_reason(_spec((4, 4, 1 << 15)), ok)
    assert bad_shape and "degenerate" in bad_shape
    bad_prod = infeasible_reason(_spec((1, 1, 1 << 15)),
                                 PlanParams(split_1d=(3, 5)))
    assert bad_prod and "split_1d" in bad_prod
    # real plans split the half-length core
    assert infeasible_reason(_spec((1, 1, 1 << 15), real=True), ok)
    assert infeasible_reason(_spec((1, 1, 1 << 16), real=True), ok) is None


def test_split1d_search_dimension():
    space = build_space(_spec((1, 1, 1 << 20), p=8))
    names = [d.name for d in space.dims]
    assert "split_1d" in names
    dim = space.dims[names.index("split_1d")]
    assert dim.values[0] is None and len(dim.values) > 1
    for sp in dim.values[1:]:
        assert sp[0] * sp[1] == 1 << 20 and sp[0] % 8 == sp[1] % 8 == 0
    # point -> params roundtrips the tuple
    pt = space.from_params(PlanParams(split_1d=dim.values[1]))
    assert space.to_params(pt).split_1d == dim.values[1]
    # one device has no distributed engine: no split dimension
    space2 = build_space(_spec((1, 1, 1 << 20)))
    assert "split_1d" not in [d.name for d in space2.dims]
