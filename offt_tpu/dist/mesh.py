"""Device mesh construction — the JAX replacement for the reference's
process-grid builder ``offt_comm_malloc`` (/root/reference/offt-compute.c:57-315).

Where the reference builds `p1 x p2` MPI groups by explicit rank lists
(comm1 = rows of size p2, comm2 = columns of size p1), we build a
``jax.sharding.Mesh`` with named axes ("row", "col"); collectives over
"col" are the phase-1 row-communicator all-to-alls, collectives over "row"
are the phase-2 column ones.

The reference optionally remaps ranks onto the grid with ROTATE_RANKORDER
(offt-compute.c:69-77,95-101 — default rank->(x=rank/p2, y=rank%p2)
row-major; rotated rank->(x=rank%p1, y=rank/p1) column-major) because on
a cluster it decides whether each communicator's members are network
neighbours. The cards of one NVLink host all reach each other at the same
rate, so the grid follows the algorithm alone: RANKORDER_AUTO is the plain
row-major order; RANKORDER_ROW / RANKORDER_COL are the reference's two
explicit orders and tuner search points (``PlanParams.rankorder``).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW = "row"     # size p1: phase-2 communicator (reference comm2)
COL = "col"     # size p2: phase-1 communicator (reference comm1)
SLICE = "slice"  # batch-group axis: batch-parallel, never a pencil

RANKORDER_AUTO = 0  # row-major placement / mesh as given
RANKORDER_ROW = 1   # device i -> (i // p2, i % p2): reference default order
RANKORDER_COL = 2   # device i -> (i % p1, i // p1): ROTATE_RANKORDER


def _grid_devices(devices, p1: int, p2: int, rankorder: int) -> np.ndarray:
    """Lay ``p1*p2`` devices onto the (ROW, COL) grid per ``rankorder``."""
    devices = list(devices)[: p1 * p2]
    if rankorder in (RANKORDER_AUTO, RANKORDER_ROW):
        return np.asarray(devices).reshape(p1, p2)
    if rankorder == RANKORDER_COL:
        return np.asarray(devices).reshape(p2, p1).T
    raise ValueError(f"rankorder must be 0|1|2, got {rankorder}")


def make_mesh(p1: int, p2: int | None = None, devices=None,
              rankorder: int = RANKORDER_AUTO) -> Mesh:
    """Build a (p1, p2) mesh. With p2=None, uses all devices: p2 = n // p1.

    ``rankorder`` picks the device->grid assignment (see module docstring);
    the default is row-major."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if p2 is None:
        if n % p1 != 0:
            raise ValueError(f"p1={p1} does not divide device count {n}")
        p2 = n // p1
    if p1 * p2 > n:
        raise ValueError(f"mesh {p1}x{p2} needs {p1 * p2} devices, have {n}")
    return Mesh(_grid_devices(devices, p1, p2, rankorder), (ROW, COL))


def with_rankorder(mesh: Mesh, rankorder: int) -> Mesh:
    """Re-grid an existing (ROW, COL) mesh's devices per ``rankorder``.

    RANKORDER_AUTO returns the mesh unchanged (the caller's placement is
    authoritative); ROW/COL rebuild the grid from the canonical
    enumeration order (device id) — the analogue of recompiling the
    reference with ROTATE_RANKORDER toggled. Returns the SAME mesh object
    when the re-gridding is a no-op so jit caches stay warm."""
    if rankorder == RANKORDER_AUTO:
        return mesh
    if SLICE in mesh.axis_names:
        raise ValueError("rankorder re-gridding applies to (row, col) "
                         "meshes only, not batch-group meshes")
    p1, p2 = mesh.shape[ROW], mesh.shape[COL]
    devices = sorted(mesh.devices.flat, key=lambda d: d.id)
    arr = _grid_devices(devices, p1, p2, rankorder)
    if all(a is b for a, b in zip(arr.flat, mesh.devices.flat)):
        return mesh
    return Mesh(arr, mesh.axis_names)


def make_multislice_mesh(slices: int, p1: int, p2: int | None = None,
                         devices=None) -> Mesh:
    """Nested (slice, p1, p2) batch-group mesh.

    The SLICE axis shards a leading batch dim (each group of p1*p2
    devices transforms its own batch shard); the pencil all_to_alls only
    ever run over ROW/COL, inside one group. Groups are contiguous blocks
    of ``devices``."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if p2 is None:
        if p1 <= 0 or (n // slices) % p1 != 0:
            raise ValueError(f"p1={p1} does not divide per-slice count "
                             f"{n // slices}")
        p2 = (n // slices) // p1
    if slices * p1 * p2 > n:
        raise ValueError(f"mesh {slices}x{p1}x{p2} needs "
                         f"{slices * p1 * p2} devices, have {n}")
    arr = np.asarray(devices[: slices * p1 * p2]).reshape(slices, p1, p2)
    return Mesh(arr, (SLICE, ROW, COL))


def _batch_spec(mesh: Mesh, ndim: int) -> tuple:
    """Leading batch-dim partition entries: the SLICE axis shards the
    first batch dim on batch-group meshes, remaining batch dims replicate."""
    nbatch = ndim - 3
    if SLICE in mesh.axis_names:
        if nbatch < 1:
            raise ValueError(
                "a batch-group mesh shards a leading batch axis over the "
                "slice axis: use batch_dims >= 1")
        return (SLICE,) + (None,) * (nbatch - 1)
    return (None,) * nbatch


def input_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Input pencil layout: x over rows, y over cols, z local (z-pencils),
    with leading batch dims replicated (or slice-sharded on a batch-group
    mesh)."""
    spec = _batch_spec(mesh, ndim) + (ROW, COL, None)
    return NamedSharding(mesh, P(*spec))


def output_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Output layout after the two transpose phases: x local, y over rows,
    z over cols — the reference's transposed-output convention
    (offt-compute.c:3892-3895,4038-4045)."""
    spec = _batch_spec(mesh, ndim) + (None, ROW, COL)
    return NamedSharding(mesh, P(*spec))


def mesh_shape(mesh: Mesh) -> tuple[int, int]:
    return mesh.shape[ROW], mesh.shape[COL]
