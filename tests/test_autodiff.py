"""Autodiff through plans (native: every pipeline is plain JAX).

Two kinds of evidence:

1. Convention tests vs jax's own jnp.fft rules (CPU): jax.grad of a
   real loss through a plan must equal the same grad through jnp.fft.
2. The implementation-true transpose identity for LINEAR maps:
   <ct, f(v)> == <vjp(ct), v> under the real pairing, for random v/ct —
   this holds for every correct vjp regardless of layout conventions
   (packed, planar, distributed), with no external reference needed.

The reference has no autodiff analogue (MPI/C); this is JAX-side API
surface (jax.grad for spectral losses / neural operators).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import offt_tpu
from offt_tpu.dist import make_mesh


def _rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _randc(shape, seed, dtype=np.complex128):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape)
            + 1j * r.standard_normal(shape)).astype(dtype)


def _dot_tree(a, b):
    """Real inner product over a pytree of real arrays, accumulated in
    float64 (the identity under test is the transpose's, not that of a
    float32 sum)."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return sum(np.vdot(np.asarray(x).astype(np.complex128),
                       np.asarray(y).astype(np.complex128)).real
               for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# 1. convention tests against jnp.fft (complex calling convention, CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("inverse", [False, True])
def test_grad_c2c_matches_jnp(norm, inverse):
    x = jnp.asarray(_randc((8, 8, 8), 0))
    p = offt_tpu.plan((8, 8, 8), x.dtype, inverse=inverse, norm=norm)
    w = jnp.asarray(_randc((8, 8, 8), 1))
    ref_fn = jnp.fft.ifftn if inverse else jnp.fft.fftn

    def loss_plan(z):
        return jnp.sum(jnp.abs(p(z) * w) ** 2)

    def loss_ref(z):
        return jnp.sum(jnp.abs(ref_fn(z, norm=norm) * w) ** 2)

    g1 = jax.grad(loss_plan)(x)
    g2 = jax.grad(loss_ref)(x)
    assert np.allclose(np.asarray(g1), np.asarray(g2), rtol=1e-10,
                       atol=1e-10)


@pytest.mark.parametrize("norm", ["backward", "ortho"])
def test_grad_rfftn_matches_jnp(norm):
    x = jnp.asarray(_rand((8, 8, 8), 2))
    p = offt_tpu.plan((8, 8, 8), "complex128", real=True, norm=norm)
    w = jnp.asarray(_randc((8, 8, 5), 3))

    g1 = jax.grad(lambda z: jnp.sum(jnp.abs(p(z) * w) ** 2))(x)
    g2 = jax.grad(lambda z: jnp.sum(
        jnp.abs(jnp.fft.rfftn(z, norm=norm) * w) ** 2))(x)
    assert np.allclose(np.asarray(g1), np.asarray(g2), rtol=1e-10,
                       atol=1e-10)


def test_grad_irfftn_hermitian_consistent():
    """Composite grad x -> irfftn(rfftn(x) * filt): a HERMITIAN-
    SYMMETRIC filter (|rfftn(real)|^2) keeps the spectrum on the
    manifold where every irfftn implementation (and transpose) agrees
    with numpy — an arbitrary real filter would break the 2-D Hermitian
    symmetry of the z=0/M planes and the implementations legitimately
    diverge off-manifold."""
    x = jnp.asarray(_rand((8, 8, 8), 4))
    pf_ = offt_tpu.plan((8, 8, 8), "complex128", real=True)
    pb = offt_tpu.plan((8, 8, 8), "complex128", real=True, inverse=True)
    filt = jnp.abs(jnp.fft.rfftn(jnp.asarray(_rand((8, 8, 8), 5)))) ** 2
    w = jnp.asarray(_rand((8, 8, 8), 6))

    g1 = jax.grad(lambda z: jnp.sum(pb(pf_(z) * filt) * w))(x)
    g2 = jax.grad(lambda z: jnp.sum(
        jnp.fft.irfftn(jnp.fft.rfftn(z) * filt) * w))(x)
    assert np.allclose(np.asarray(g1), np.asarray(g2), rtol=1e-10,
                       atol=1e-10)


# ---------------------------------------------------------------------------
# 2. transpose identity <ct, f(v)> == <vjp(ct), v> (implementation-true)
# ---------------------------------------------------------------------------

def _conj_leaves(t):
    return jax.tree_util.tree_map(
        lambda c: jnp.conj(c) if jnp.iscomplexobj(c) else c, t)


def _check_transpose(f, args, seed=7, tol=1e-6):
    """<ct, f(v)>_R == <vjp(ct), v>_R under the real pairing. JAX's
    complex-cotangent convention is conj∘T∘conj, so complex leaves are
    conjugated on both sides (a no-op for planar/real paths)."""
    y, vjp = jax.vjp(f, *args)

    leaf_seed = [seed]

    def mk(a):
        a = np.asarray(a)
        leaf_seed[0] += 1  # distinct per leaf: identical (ctr, cti)
        # planar cotangents would mask re/im cross-wiring bugs
        if np.iscomplexobj(a):
            return jnp.asarray(_randc(a.shape, leaf_seed[0], a.dtype))
        return jnp.asarray(_rand(a.shape, leaf_seed[0], a.dtype))

    ct = jax.tree_util.tree_map(mk, y)
    g = vjp(ct)
    lhs = _dot_tree(_conj_leaves(ct), y)
    rhs = _dot_tree(_conj_leaves(g), args)
    assert np.isclose(float(lhs), float(rhs), rtol=tol), (lhs, rhs)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_transpose_c2c_planar(inverse, norm):
    """complex64 on the matmul engine, whose transpose replays the same
    matmuls and so holds the identity to 1e-6 in float32 (the XLA engine's
    transpose is an independent FFT call: checked in complex128 below)."""
    from offt_tpu.plan.params import PlanParams

    p = offt_tpu.plan((16, 8, 8), "complex64", inverse=inverse, norm=norm,
                      planar=True, params=PlanParams(engine="matmul"))
    re = jnp.asarray(_rand((16, 8, 8), 8, np.float32))
    im = jnp.asarray(_rand((16, 8, 8), 9, np.float32))
    _check_transpose(lambda r, i: p((r, i)), (re, im))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_transpose_c2c_planar_xla_fp64(inverse, norm):
    p = offt_tpu.plan((16, 8, 8), "complex128", inverse=inverse, norm=norm,
                      planar=True)
    re = jnp.asarray(_rand((16, 8, 8), 8))
    im = jnp.asarray(_rand((16, 8, 8), 9))
    _check_transpose(lambda r, i: p((r, i)), (re, im), tol=1e-12)


@pytest.mark.parametrize("packed", [False, True])
def test_transpose_rfft_planar(packed):
    shape = (16, 16, 256) if packed else (16, 8, 8)
    p = offt_tpu.plan(shape, "complex64", real=True, planar=True,
                      packed=packed)
    x = jnp.asarray(_rand(shape, 10, np.float32))
    # f32 pipelines on both sides of the identity: ~1e-5 relative
    _check_transpose(lambda z: p(z), (x,), tol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
def test_transpose_irfft_planar(packed):
    shape = (16, 16, 256) if packed else (16, 8, 8)
    nf = shape[2] // 2 if packed else shape[2] // 2 + 1
    p = offt_tpu.plan(shape, "complex64", real=True, inverse=True,
                      planar=True, packed=packed)
    fr = jnp.asarray(_rand(shape[:2] + (nf,), 11, np.float32))
    fi = jnp.asarray(_rand(shape[:2] + (nf,), 12, np.float32))
    _check_transpose(lambda r, i: p((r, i)), (fr, fi), tol=1e-4)


def test_transpose_irfft_complex_nonplanar_fused():
    """complex64 non-planar irfft through the local pipeline: the
    transpose identity holds under JAX's complex conj convention."""
    shape = (16, 16, 256)
    p = offt_tpu.plan(shape, "complex64", real=True, inverse=True)
    f = jnp.asarray(_randc((16, 16, 129), 21, np.complex64))

    def fn(re, im):
        return p(jax.lax.complex(re, im))

    _check_transpose(fn, (jnp.real(f), jnp.imag(f)), tol=1e-4)


def test_transpose_irfft_odd_n():
    p = offt_tpu.plan((8, 8, 7), "complex128", real=True, inverse=True)
    f = jnp.asarray(_randc((8, 8, 4), 13))

    def fn(re, im):
        return p(jax.lax.complex(re, im))

    # the generic odd-N pipeline ignores Im at the self-paired bin 0;
    # check the transpose identity over the REAL planar coordinates
    re = jnp.real(f)
    im = jnp.imag(f)
    _check_transpose(fn, (re, im), tol=1e-9)


# ---------------------------------------------------------------------------
# distributed plans (8 virtual CPU devices)
# ---------------------------------------------------------------------------

def test_grad_distributed_c2c_matches_local():
    mesh = make_mesh(2, 4)
    x = jnp.asarray(_randc((16, 16, 16), 14))
    w = jnp.asarray(_randc((16, 16, 16), 15))
    pd = offt_tpu.plan((16, 16, 16), x.dtype, mesh=mesh)
    pl_ = offt_tpu.plan((16, 16, 16), x.dtype)

    def loss(p):
        return lambda z: jnp.sum(jnp.abs(p(z) * w) ** 2)

    g1 = jax.grad(loss(pd))(x)
    g2 = jax.grad(loss(pl_))(x)
    assert np.allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9,
                       atol=1e-9)


def test_transpose_distributed_rfft():
    mesh = make_mesh(2, 4)
    p = offt_tpu.plan((16, 16, 16), "complex128", real=True, mesh=mesh)
    x = jnp.asarray(_rand((16, 16, 16), 16))
    _check_transpose(lambda z: p(z), (x,), tol=1e-9)


def test_grad_distributed_irfft_native():
    """Distributed fp64 c2r plans are pure-jnp pipelines — native
    autodiff must match the local grad."""
    mesh = make_mesh(2, 4)
    f = jnp.asarray(_randc((16, 16, 9), 19))
    w = jnp.asarray(_rand((16, 16, 16), 20))
    pd = offt_tpu.plan((16, 16, 16), "complex128", real=True, inverse=True,
                       mesh=mesh)
    pl_ = offt_tpu.plan((16, 16, 16), "complex128", real=True, inverse=True)

    g1 = jax.grad(lambda z: jnp.sum(pd(z) * w).real,
                  holomorphic=False)(f)
    g2 = jax.grad(lambda z: jnp.sum(pl_(z) * w).real,
                  holomorphic=False)(f)
    assert np.allclose(np.asarray(g1), np.asarray(g2), rtol=1e-9,
                       atol=1e-9)


def test_transpose_distributed_irfft_c64():
    """Distributed complex64 c2r: the transpose identity through the
    pencil pipeline's c2r z-stage."""
    mesh = make_mesh(2, 4)
    p = offt_tpu.plan((16, 16, 16), "complex64", real=True, inverse=True,
                      mesh=mesh)
    f = jnp.asarray(_randc((16, 16, 9), 22, np.complex64))

    def fn(re, im):
        return p(jax.lax.complex(re, im))

    _check_transpose(fn, (jnp.real(f), jnp.imag(f)), tol=1e-4)


def test_grad_distributed_c2r_composite_c64():
    """Distributed complex64 rfft -> symmetric filter -> irfft composite:
    the gradient matches numpy's end-to-end (the on-manifold statement
    from DESIGN.md 4b — a radially symmetric filter keeps the spectrum
    Hermitian, where every correct irfft transpose agrees)."""
    mesh = make_mesh(2, 4)
    n = 16
    x = jnp.asarray(_rand((n, n, n), 31, np.float32))
    fx = np.fft.fftfreq(n)[:, None, None]
    fy = np.fft.fftfreq(n)[None, :, None]
    fz = np.fft.rfftfreq(n)[None, None, :]
    k = jnp.asarray(np.exp(-40.0 * (fx**2 + fy**2 + fz**2))
                    .astype(np.float32))
    pf = offt_tpu.plan((n, n, n), "complex64", real=True, mesh=mesh)
    pi = offt_tpu.plan((n, n, n), "complex64", real=True, inverse=True,
                       mesh=mesh)

    g1 = jax.grad(lambda v: jnp.sum(pi(pf(v) * k) ** 2))(x)
    g2 = jax.grad(lambda v: jnp.sum(
        jnp.fft.irfftn(jnp.fft.rfftn(v) * k, s=(n, n, n)) ** 2))(x)
    rel = float(jnp.linalg.norm(g1 - g2) / jnp.linalg.norm(g2))
    assert rel < 1e-5, rel


@pytest.mark.parametrize("packed", [False, True])
def test_transpose_distributed_irfft_planar_c64(packed):
    """Planar distributed complex64 c2r (both layouts): the pack^T +
    interior-doubling adjoint composes with the pencil pipeline."""
    mesh = make_mesh(2, 4)
    n = 16
    nf = n // 2 if packed else n // 2 + 1
    p = offt_tpu.plan((n, n, n), "complex64", real=True, inverse=True,
                      mesh=mesh, planar=True, packed=packed)
    xr = jnp.asarray(_rand((n, n, nf), 33, np.float32))
    xi = jnp.asarray(_rand((n, n, nf), 34, np.float32))
    _check_transpose(lambda a, b: p((a, b)), (xr, xi), tol=1e-4)


def test_jvp_native_fp64():
    """Plans differentiate natively, so forward mode works."""
    p = offt_tpu.plan((8, 8, 8), "complex128")
    x = jnp.asarray(_randc((8, 8, 8), 23))
    dx = jnp.asarray(_randc((8, 8, 8), 24))
    y, dy = jax.jvp(lambda z: p(z), (x,), (dx,))
    # linear: tangent == plan(tangent)
    assert np.allclose(np.asarray(dy), np.asarray(p(dx)), rtol=1e-12)


def test_odd_n_c64_c2r_grad():
    """Odd-N complex64 c2r: native autodiff (no Nyquist bin)."""
    p = offt_tpu.plan((8, 8, 7), "complex64", real=True, inverse=True)
    f = jnp.asarray(_randc((8, 8, 4), 25, np.complex64))

    def fn(re, im):
        return p(jax.lax.complex(re, im))

    _check_transpose(fn, (jnp.real(f), jnp.imag(f)), tol=1e-4)


def test_grad_under_jit_composes():
    p = offt_tpu.plan((8, 8, 8), "complex64", planar=True)

    @jax.jit
    def g(re, im):
        return jax.grad(
            lambda r, i: jnp.sum(p((r, i))[0] ** 2), argnums=(0, 1))(re, im)

    re = jnp.asarray(_rand((8, 8, 8), 17, np.float32))
    im = jnp.asarray(_rand((8, 8, 8), 18, np.float32))
    gr, gi = g(re, im)
    assert gr.shape == (8, 8, 8)
    # cross-check against jnp.fft with the same planar loss
    g2r, g2i = jax.grad(
        lambda r, i: jnp.sum(
            jnp.real(jnp.fft.fftn(jax.lax.complex(r, i))) ** 2),
        argnums=(0, 1))(re, im)
    assert np.allclose(np.asarray(gr), np.asarray(g2r), rtol=1e-4,
                       atol=1e-4)
    assert np.allclose(np.asarray(gi), np.asarray(g2i), rtol=1e-4,
                       atol=1e-4)


@pytest.mark.parametrize("trial", range(5))
def test_fuzz_transpose_wrapped_c64(trial):
    """Random shapes x direction x norm x engine (complex64 planar): the
    transpose identity must hold."""
    from offt_tpu.plan.params import PlanParams

    rng = np.random.default_rng(4200 + trial)
    dims = [8, 16, 24, 32, 64]
    shape = tuple(int(rng.choice(dims)) for _ in range(3))
    inverse = bool(rng.integers(0, 2))
    norm = [None, "ortho", "forward"][int(rng.integers(0, 3))]
    pp = PlanParams(engine=("xla", "matmul")[trial % 2])
    p = offt_tpu.plan(shape, "complex64", inverse=inverse, norm=norm,
                      planar=True, params=pp)
    re = jnp.asarray(_rand(shape, 100 + trial, np.float32))
    im = jnp.asarray(_rand(shape, 200 + trial, np.float32))
    _check_transpose(lambda r, i: p((r, i)), (re, im), tol=1e-4)


def test_transpose_irfft_odd_n_wrapped_c64():
    """Odd-N complex64 c2r on the matmul engine: the transpose identity
    through its Hermitian-extension pipeline."""
    for shape, nf in (((8, 8, 7), 4), ((16, 16, 27), 14)):
        base = offt_tpu.plan(shape, "complex64", real=True,
                             inverse=True).params
        p = offt_tpu.plan(shape, "complex64", real=True, inverse=True,
                          params=base.replace(engine="matmul"))
        f = jnp.asarray(_randc(shape[:-1] + (nf,), 41, np.complex64))
        _check_transpose(lambda re, im: p(jax.lax.complex(re, im)),
                         (jnp.real(f), jnp.imag(f)), tol=1e-4)


def test_transpose_distributed_irfft_odd_n_c64():
    mesh = make_mesh(2, 4)
    p = offt_tpu.plan((16, 16, 27), "complex64", real=True, inverse=True,
                      mesh=mesh)
    f = jnp.asarray(_randc((16, 16, 14), 42, np.complex64))
    _check_transpose(lambda re, im: p(jax.lax.complex(re, im)),
                     (jnp.real(f), jnp.imag(f)), tol=1e-4)


def test_grad_odd_n_c2r_composite_matches_numpy():
    """Odd-N on-manifold composite: rfft -> symmetric filter -> irfft
    grad matches numpy end-to-end (no manifold caveat for odd N — there
    is no self-paired Nyquist bin for implementations to disagree on)."""
    n = 27
    shape = (8, 8, n)
    x = jnp.asarray(_rand(shape, 43, np.float32))
    fz = np.fft.rfftfreq(n)[None, None, :]
    fx = np.fft.fftfreq(8)[:, None, None]
    fy = np.fft.fftfreq(8)[None, :, None]
    k = jnp.asarray(np.exp(-10 * (fx**2 + fy**2 + fz**2)).astype(np.float32))
    bf = offt_tpu.plan(shape, "complex64", real=True).params
    pf = offt_tpu.plan(shape, "complex64", real=True,
                       params=bf.replace(engine="matmul"))
    pi = offt_tpu.plan(shape, "complex64", real=True, inverse=True,
                       params=bf.replace(engine="matmul"))
    g1 = jax.grad(lambda v: jnp.sum(pi(pf(v) * k) ** 2))(x)
    g2 = jax.grad(lambda v: jnp.sum(
        jnp.fft.irfftn(jnp.fft.rfftn(v) * k, s=shape) ** 2))(x)
    rel = float(jnp.linalg.norm(g1 - g2) / jnp.linalg.norm(g2))
    assert rel < 1e-5, rel


def test_jvp_wrapped_planar_c2c():
    """Forward mode through PLANAR plans (the jvp of a linear map is the
    map itself)."""
    p = offt_tpu.plan((16, 8, 8), "complex64", planar=True)
    re = jnp.asarray(_rand((16, 8, 8), 51, np.float32))
    im = jnp.asarray(_rand((16, 8, 8), 52, np.float32))
    tr = jnp.asarray(_rand((16, 8, 8), 53, np.float32))
    ti = jnp.asarray(_rand((16, 8, 8), 54, np.float32))
    _, t = jax.jvp(lambda a, b: p((a, b)), (re, im), (tr, ti))
    want = np.fft.fftn(np.asarray(tr) + 1j * np.asarray(ti))
    got = np.asarray(t[0]) + 1j * np.asarray(t[1])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_jvp_wrapped_complex_c2c_and_grad_of_grad():
    """Complex c2c: jvp works, and second-order AD is exact."""
    pc = offt_tpu.plan((8, 8, 8), "complex64")
    x = jnp.asarray(_randc((8, 8, 8), 55, np.complex64))
    tx = jnp.asarray(_randc((8, 8, 8), 56, np.complex64))
    _, tv = jax.jvp(pc, (x,), (tx,))
    ref = jnp.fft.fftn(tx)
    assert float(jnp.linalg.norm(tv - ref) / jnp.linalg.norm(ref)) < 1e-5

    def loss(v):
        return jnp.sum(jnp.abs(pc(v)) ** 2)

    def meta(v):
        return jnp.sum(jnp.abs(jax.grad(loss)(v)) ** 2)

    def meta_ref(v):
        g = jax.grad(lambda u: jnp.sum(jnp.abs(jnp.fft.fftn(u)) ** 2))(v)
        return jnp.sum(jnp.abs(g) ** 2)

    h = jax.grad(meta)(x)
    h2 = jax.grad(meta_ref)(x)
    assert float(jnp.linalg.norm(h - h2) / jnp.linalg.norm(h2)) < 1e-5


def test_jvp_wrapped_planar_rfft_irfft():
    pr = offt_tpu.plan((16, 8, 8), "complex64", real=True, planar=True)
    x = jnp.asarray(_rand((16, 8, 8), 57, np.float32))
    tx = jnp.asarray(_rand((16, 8, 8), 58, np.float32))
    _, (tvr, tvi) = jax.jvp(lambda v: pr(v), (x,), (tx,))
    want = np.fft.rfftn(np.asarray(tx))
    got = np.asarray(tvr) + 1j * np.asarray(tvi)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5

    pi = offt_tpu.plan((16, 8, 8), "complex64", real=True, inverse=True,
                       planar=True)
    fr = jnp.asarray(_rand((16, 8, 5), 59, np.float32))
    fi = jnp.asarray(_rand((16, 8, 5), 60, np.float32))
    tfr = jnp.asarray(_rand((16, 8, 5), 61, np.float32))
    tfi = jnp.asarray(_rand((16, 8, 5), 62, np.float32))
    y, t = jax.jvp(lambda a, b: pi((a, b)), (fr, fi), (tfr, tfi))
    want = np.asarray(pi((tfr, tfi)))     # linearity: jvp == the map
    assert np.linalg.norm(np.asarray(t) - want) / np.linalg.norm(want) < 1e-5


def test_jvp_wrapped_distributed_planar():
    mesh = make_mesh(2, 4)
    p = offt_tpu.plan((16, 16, 16), "complex64", planar=True, mesh=mesh)
    re = jnp.asarray(_rand((16, 16, 16), 63, np.float32))
    im = jnp.asarray(_rand((16, 16, 16), 64, np.float32))
    tr = jnp.asarray(_rand((16, 16, 16), 65, np.float32))
    ti = jnp.asarray(_rand((16, 16, 16), 66, np.float32))
    _, t = jax.jvp(lambda a, b: p((a, b)), (re, im), (tr, ti))
    want = np.fft.fftn(np.asarray(tr) + 1j * np.asarray(ti))
    got = np.asarray(t[0]) + 1j * np.asarray(t[1])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_vmap_and_vmap_of_grad_compose():
    """jax.vmap (and vmap∘grad) through a planar plan."""
    p = offt_tpu.plan((8, 8, 8), "complex64", planar=True)
    re = jnp.asarray(_rand((3, 8, 8, 8), 71, np.float32))
    im = jnp.asarray(_rand((3, 8, 8, 8), 72, np.float32))
    yr, yi = jax.vmap(lambda a, b: p((a, b)))(re, im)
    want = np.fft.fftn(np.asarray(re) + 1j * np.asarray(im),
                       axes=(-3, -2, -1))
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    g = jax.vmap(jax.grad(lambda a, b: jnp.sum(p((a, b))[0] ** 2),
                          argnums=0))(re, im)
    assert g.shape == (3, 8, 8, 8)
