"""Device->grid rank-order knob (reference ROTATE_RANKORDER,
offt-compute.c:69-77,95-101): the assignment of devices to the (row, col)
grid is a tunable, and every ordering computes the identical transform."""

import numpy as np
import pytest

import jax

import offt_tpu
from offt_tpu.dist import (
    RANKORDER_AUTO,
    RANKORDER_COL,
    RANKORDER_ROW,
    make_mesh,
    with_rankorder,
)
from offt_tpu.plan.params import PlanParams, ProblemSpec, infeasible_reason


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a.ravel() - b.ravel()) / np.linalg.norm(b.ravel())


def rand_c(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex128)


def _ids(mesh):
    return [d.id for d in mesh.devices.flat]


def test_rankorder_changes_device_grid():
    # 2x4: row-major rows are [0,1,2,3] and [4,5,6,7]; column-major
    # (ROTATE_RANKORDER) rows are the strided [0,2,4,6] / [1,3,5,7]
    m_row = make_mesh(2, 4, rankorder=RANKORDER_ROW)
    m_col = make_mesh(2, 4, rankorder=RANKORDER_COL)
    assert _ids(m_row) == [0, 1, 2, 3, 4, 5, 6, 7]
    assert _ids(m_col) == [0, 2, 4, 6, 1, 3, 5, 7]
    assert m_row.shape == m_col.shape


def test_with_rankorder_regrids_and_is_idempotent():
    m = make_mesh(2, 4, rankorder=RANKORDER_ROW)
    m_col = with_rankorder(m, RANKORDER_COL)
    assert _ids(m_col) == [0, 2, 4, 6, 1, 3, 5, 7]
    # AUTO keeps the caller's mesh object; a no-op re-grid returns the
    # same object so jit caches keyed on the mesh stay warm
    assert with_rankorder(m, RANKORDER_AUTO) is m
    assert with_rankorder(m, RANKORDER_ROW) is m
    assert with_rankorder(m_col, RANKORDER_COL) is not m
    assert _ids(with_rankorder(m_col, RANKORDER_ROW)) == _ids(m)


def test_auto_is_topology_aware_fallback():
    # AUTO must produce a full valid grid
    m = make_mesh(4, 2)
    assert sorted(_ids(m)) == list(range(8))


@pytest.mark.parametrize("p1,p2", [(2, 4), (4, 2), (1, 8), (2, 2)])
def test_auto_is_row_major(p1, p2):
    """On one NVLink host every card reaches every other at the same
    rate, so AUTO is the plain row-major order of the device list."""
    devs = jax.devices()
    m = make_mesh(p1, p2)
    assert [d.id for d in m.devices.flat] == [d.id for d in devs[:p1 * p2]]
    assert _ids(m) == _ids(make_mesh(p1, p2, rankorder=RANKORDER_ROW))


@pytest.mark.parametrize("ro", [RANKORDER_AUTO, RANKORDER_ROW, RANKORDER_COL])
def test_plan_rankorder_knob_identical_results(ro):
    """The knob changes placement only: results match numpy at the fp64
    bar and are bit-identical across orderings (same per-shard programs,
    different devices)."""
    x = rand_c((16, 16, 16), seed=3)
    base = make_mesh(2, 4, rankorder=RANKORDER_ROW)
    p = offt_tpu.plan((16, 16, 16), "complex128", mesh=base,
                      params=PlanParams(p1=2, rankorder=ro), use_cache=False)
    got = np.asarray(p(x))
    assert rel_err(got, np.fft.fftn(x)) < 1e-12
    if ro == RANKORDER_COL:
        assert _ids(p.mesh) == [0, 2, 4, 6, 1, 3, 5, 7]
    ref = offt_tpu.plan((16, 16, 16), "complex128", mesh=base,
                        params=PlanParams(p1=2), use_cache=False)
    np.testing.assert_array_equal(got, np.asarray(ref(x)))


def test_rankorder_feasibility():
    spec = ProblemSpec(shape=(16, 16, 16), p=8)
    assert infeasible_reason(spec, PlanParams(p1=2, rankorder=2)) is None
    assert "rankorder" in infeasible_reason(
        spec, PlanParams(p1=2, rankorder=3))


def test_rankorder_in_search_space():
    from offt_tpu.tune.space import build_space
    space = build_space(ProblemSpec(shape=(16, 16, 16), p=8))
    names = space.names
    assert "rankorder" in names
    d = space.dims[names.index("rankorder")]
    assert d.values == (0, 1, 2)


def test_multislice_mesh_rejects_regrid():
    from offt_tpu.dist import make_multislice_mesh
    m = make_multislice_mesh(2, 2, 2)
    with pytest.raises(ValueError):
        with_rankorder(m, RANKORDER_COL)
