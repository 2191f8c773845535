"""Distributed 3-D FFT over a (p1, p2) mesh: the pencil dataflow.

JAX re-expression of the reference's two-phase overlap engine
(/root/reference/offt-compute.c:3501-3862 ``offt_3d_execute_phase{1,2}`` and
the four pack/a2a/unpack kernels, offt-compute.c:905-2993):

    z-pencils (x/p1, y/p2, z)   --fft_z-->
      --[phase 1: all_to_all over COL, z<->y]-->
    y-pencils (x/p1, y, z/p2)   --fft_y-->
      --[phase 2: all_to_all over ROW, y<->x]-->
    x-pencils (x, y/p1, z/p2)   --fft_x-->   transposed-out layout

Differences from the reference, by design (SURVEY.md §5 "Distributed
communication backend"):

- MPI groups/Ialltoallv/MPI_Test progress -> named-axis collectives under
  ``jax.shard_map``; collectives progress on their own, so the 8 F* knobs
  vanish.
- pack/unpack memcpy nests -> nothing: GSPMD + XLA layout assignment own
  data movement; what remains tunable is the *pipeline*: each phase is
  chunked into t1/t2 slices whose per-slice collectives XLA's async
  scheduler overlaps with neighbouring slices' local transforms (the
  reference's T/W tiling, offt.h:74-79).
- the S knob becomes the transpose strategy: one fused all_to_all (s=0) or
  a ring of collective_permutes (s=1) that decomposes the exchange into
  p-1 single-hop steps, each overlappable.

The same machinery runs forward and inverse (mirror-symmetric pipeline) and
slab decompositions (p1 == 1 or p2 == 1 make one phase's collective
trivial, the analogue of METHOD ONE / METHOD OLD, offt-compute.c:3896-3998).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..kernels.stockham import fft_1d
from ..plan.params import ENGINE_XLA, TRANSPOSE_PPERMUTE, PlanParams
from .mesh import COL, ROW, _batch_spec, mesh_shape


def axis_fft(c, axis: int, inverse: bool, radices, params: PlanParams):
    """Local complex 1-D transform along ``axis`` (numpy fft/ifft
    semantics, inverse scaled by 1/n) on the plan's engine: XLA's FFT
    (cuFFT on the GPU) or the matmul chain with ``radices``."""
    if params.engine == ENGINE_XLA:
        return (jnp.fft.ifft if inverse else jnp.fft.fft)(c, axis=axis)
    return fft_1d(c, axis=axis, inverse=inverse, radices=radices,
                  precision=params.precision)


def _ring_all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, size: int):
    """all_to_all decomposed into a ring of single-hop collective_permutes.

    Equivalent to ``lax.all_to_all(tiled=True)`` but each of the size-1 hops
    is an independent collective the scheduler can overlap with compute
    (the explicit-overlap fallback of SURVEY.md §7 step 4).
    """
    if size == 1:
        return x
    me = lax.axis_index(axis_name)
    chunk = x.shape[split_axis] // size
    out_shape = list(x.shape)
    out_shape[split_axis] = chunk
    out_shape[concat_axis] = x.shape[concat_axis] * size

    def piece(dst_idx):
        return lax.dynamic_slice_in_dim(x, dst_idx * chunk, chunk, split_axis)

    out = jnp.zeros(out_shape, x.dtype)
    own = piece(me)
    out = lax.dynamic_update_slice_in_dim(
        out, own, me * x.shape[concat_axis], concat_axis
    )
    for s in range(1, size):
        dst = (me + s) % size
        src = (me - s) % size
        perm = [(i, (i + s) % size) for i in range(size)]
        recv = lax.ppermute(piece(dst), axis_name, perm)
        out = lax.dynamic_update_slice_in_dim(
            out, recv, src * x.shape[concat_axis], concat_axis
        )
    return out


def _transpose(x, axis_name: str, split_axis: int, concat_axis: int,
               size: int, strategy: int, variant: int = 0):
    """One pencil exchange. ``strategy`` picks fused all_to_all (0) vs the
    ppermute ring (1); ``variant`` (the reference's per-phase V bit,
    offt.h:96 — alltoallv vs padded alltoall) picks an alternative exchange
    primitive: all_gather along the concat axis + a local static slice.
    The gather moves size-x more data but is one latency-optimal collective
    — it wins for small, latency-bound exchanges (the tuner decides)."""
    if size == 1:
        return x
    if variant:
        # gather along a new leading axis (the layout every backend's
        # all-gather wants), then fold it into concat_axis
        g = lax.all_gather(x, axis_name, axis=0, tiled=False)
        g = jnp.moveaxis(g, 0, concat_axis)
        shape = list(x.shape)
        shape[concat_axis] *= size
        g = g.reshape(shape)
        me = lax.axis_index(axis_name)
        chunk = x.shape[split_axis] // size
        return lax.dynamic_slice_in_dim(g, me * chunk, chunk, split_axis)
    if strategy == TRANSPOSE_PPERMUTE:
        return _ring_all_to_all(x, axis_name, split_axis, concat_axis, size)
    return lax.all_to_all(x, axis_name, split_axis, concat_axis, tiled=True)


def _chunk_bounds(n: int, t: int) -> list[tuple[int, int]]:
    """Split range(n) into t near-equal contiguous chunks (static)."""
    t = max(1, min(t, n))
    base, rem = divmod(n, t)
    bounds = []
    start = 0
    for i in range(t):
        size = base + (1 if i < rem else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def pencil_pipeline(
    xl: jax.Array,
    *,
    a_first: int,
    a_mid: int,
    a_last: int,
    name1: str,
    size1: int,
    name2: str,
    size2: int,
    params: PlanParams,
    inverse: bool,
    rad_first=None,
    rad_mid=None,
    rad_last=None,
    first_fn: Optional[Callable] = None,
    last_fn: Optional[Callable] = None,
    pad_first: int = 0,
    mid_true: int = 0,
    mid_pad: int = 0,
    last_true: int = 0,
):
    """The two-phase chunked pipeline on one device's shard (inside shard_map).

    Forward c2c:  a_first=z, a_mid=y, a_last=x, name1=COL, name2=ROW.
    Inverse c2c:  a_first=x, a_mid=y, a_last=z, name1=ROW, name2=COL.
    ``first_fn``/``last_fn`` override the local transform on the first/last
    axis (used for r2c/c2r folding).

    Padded-shard support (the reference handles uneven division with
    variable-count MPI_Ialltoallv, offt.h:109-125 A2AV; XLA wants static
    equal shards, so we pad axes to mesh-axis multiples and carry trailing
    garbage that never mixes — FFTs only run on sliced-true extents):
    - pad_first: pad a_first to this length after do_first (pre-split)
    - mid_true:  slice a_mid to this after the phase-1 exchange
    - mid_pad:   pad a_mid to this before the phase-2 exchange
    - last_true: slice a_last to this before do_last
    """
    do_first = first_fn or (lambda c: axis_fft(c, a_first, inverse,
                                               rad_first, params))
    do_last = last_fn or (lambda c: axis_fft(c, a_last, inverse,
                                             rad_last, params))
    do_mid = lambda c: axis_fft(c, a_mid, inverse, rad_mid, params)

    mid, rx, n_rows = _phase1(
        xl, do_first=do_first, do_mid=do_mid, a_first=a_first, a_mid=a_mid,
        a_last=a_last, name1=name1, size1=size1, params=params,
        pad_first=pad_first, mid_true=mid_true)
    return _phase2(
        mid, do_mid=do_mid, do_last=do_last, a_first=a_first, a_mid=a_mid,
        a_last=a_last, name2=name2, size2=size2, params=params,
        mid_pad=mid_pad, last_true=last_true, rx=rx, n_rows=n_rows)


def _window_tie(c, outputs, w, i, t_active):
    """The window knob w bounds concurrently-live chunks (reference W1/W2,
    offt.h:78-79): chunk i's input is tied to chunk i-w's finished exchange
    with an optimization_barrier, so XLA's async scheduler keeps at most w
    chunk collectives in flight. w=0 leaves scheduling entirely to XLA
    (no bound; the reference's w=0-blocking maps to our w=1)."""
    if 0 < w <= i and w < t_active:
        c, _ = lax.optimization_barrier((c, outputs[i - w]))
    return c


def _pad_to(c, axis, target):
    cur = c.shape[axis]
    if not target or cur >= target:
        return c
    padw = [(0, 0)] * c.ndim
    padw[axis] = (0, target - cur)
    return jnp.pad(c, padw)


def _slice_to(c, axis, target):
    if not target or c.shape[axis] <= target:
        return c
    return lax.slice_in_dim(c, 0, target, axis=axis)


def _phase1(xl, *, do_first, do_mid, a_first, a_mid, a_last, name1, size1,
            params, pad_first, mid_true, max_chunks: int = 0):
    """Chunk along a_last; fft(a_first) + exchange a_first<->a_mid per
    chunk; then the ry head-fraction of the mid-axis transform.
    ``max_chunks`` > 0 truncates to the first k chunks (FAST_TUNING trial,
    offt-compute.c:3538-3548) — output covers only those rows."""
    n_last_local = xl.shape[a_last]
    bounds1 = _chunk_bounds(n_last_local, params.t1)
    if max_chunks:
        bounds1 = bounds1[:max_chunks]
    phase1_chunks = []
    for i, (lo, hi) in enumerate(bounds1):
        c = lax.slice_in_dim(xl, lo, hi, axis=a_last)
        c = _window_tie(c, phase1_chunks, params.w1, i, len(bounds1))
        c = do_first(c)
        c = _pad_to(c, a_first, pad_first)
        c = _transpose(c, name1, split_axis=a_first, concat_axis=a_mid,
                       size=size1, strategy=params.s1,
                       variant=params.v & 1)
        phase1_chunks.append(c)
    mid = jnp.concatenate(phase1_chunks, axis=a_last) if len(phase1_chunks) > 1 \
        else phase1_chunks[0]
    mid = _slice_to(mid, a_mid, mid_true)

    # mid-axis transform split between phases (reference Ry, offt.h:94):
    # first ry/10 of the a_last rows get their mid-axis fft "in phase 1".
    n_rows = mid.shape[a_last]
    rx = (n_rows * params.ry + 9) // 10 if params.ry < 10 else n_rows
    if rx > 0:
        head = lax.slice_in_dim(mid, 0, rx, axis=a_last)
        head = do_mid(head)
        if rx < n_rows:
            tail = lax.slice_in_dim(mid, rx, n_rows, axis=a_last)
            mid = jnp.concatenate([head, tail], axis=a_last)
        else:
            mid = head
    return mid, rx, n_rows


def _phase2(mid, *, do_mid, do_last, a_first, a_mid, a_last, name2, size2,
            params, mid_pad, last_true, rx, n_rows, max_chunks: int = 0):
    """Chunk along a_first; finish fft(a_mid) on pending rows, exchange
    a_mid<->a_last, fft(a_last). ``max_chunks`` truncates (trial mode)."""
    n_first_local = mid.shape[a_first]
    bounds2 = _chunk_bounds(n_first_local, params.t2)
    if max_chunks:
        bounds2 = bounds2[:max_chunks]
    out_chunks = []
    for i, (lo, hi) in enumerate(bounds2):
        c = lax.slice_in_dim(mid, lo, hi, axis=a_first)
        c = _window_tie(c, out_chunks, params.w2, i, len(bounds2))
        if rx < n_rows:
            done = lax.slice_in_dim(c, 0, rx, axis=a_last)
            pend = lax.slice_in_dim(c, rx, n_rows, axis=a_last)
            pend = do_mid(pend)
            c = jnp.concatenate([done, pend], axis=a_last)
        c = _pad_to(c, a_mid, mid_pad)
        c = _transpose(c, name2, split_axis=a_mid, concat_axis=a_last,
                       size=size2, strategy=params.s2,
                       variant=(params.v >> 1) & 1)
        c = _slice_to(c, a_last, last_true)
        c = do_last(c)
        out_chunks.append(c)
    return (jnp.concatenate(out_chunks, axis=a_first)
            if len(out_chunks) > 1 else out_chunks[0])


def _spatial_axes(ndim: int) -> tuple[int, int, int]:
    return ndim - 3, ndim - 2, ndim - 1


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def make_pencil_fft3d(
    mesh,
    ndim: int,
    params: PlanParams,
    shape: tuple[int, int, int],
    inverse: bool = False,
    rad_z=None,
    rad_y=None,
    rad_x=None,
    first_fn: Optional[Callable] = None,
    last_fn: Optional[Callable] = None,
    z_freq_len: int = 0,
):
    """Build the shard_map'd distributed transform for arrays of rank ndim
    (leading ndim-3 dims are replicated batch). Returns a traceable fn.

    ``shape`` is the TRUE spatial (Nx, Ny, Nz); the caller pads its global
    operand to mesh multiples (see plan/api.py) and this pipeline carries
    pad/slice points so uneven shapes work on static shards (A2AV parity).
    ``z_freq_len`` overrides the post-``first_fn`` z length (r2c: Nz//2+1).

    Forward maps z-pencil input P(ROW, COL, None) to transposed-out
    P(None, ROW, COL); inverse maps the reverse.
    """
    p1, p2 = mesh_shape(mesh)
    nx, ny, nz = shape
    nzt = z_freq_len or nz
    ax, ay, az = _spatial_axes(ndim)
    batch = _batch_spec(mesh, ndim)
    in_spec = P(*batch, ROW, COL, None) if not inverse else P(*batch, None, ROW, COL)
    out_spec = P(*batch, None, ROW, COL) if not inverse else P(*batch, ROW, COL, None)

    def local_fn(xl):
        if not inverse:
            return pencil_pipeline(
                xl, a_first=az, a_mid=ay, a_last=ax,
                name1=COL, size1=p2, name2=ROW, size2=p1,
                params=params, inverse=False,
                rad_first=rad_z, rad_mid=rad_y, rad_last=rad_x,
                first_fn=first_fn, last_fn=last_fn,
                pad_first=_ceil_to(nzt, p2), mid_true=ny,
                mid_pad=_ceil_to(ny, p1), last_true=nx,
            )
        return pencil_pipeline(
            xl, a_first=ax, a_mid=ay, a_last=az,
            name1=ROW, size1=p1, name2=COL, size2=p2,
            params=params, inverse=True,
            rad_first=rad_x, rad_mid=rad_y, rad_last=rad_z,
            first_fn=first_fn, last_fn=last_fn,
            pad_first=_ceil_to(nx, p1), mid_true=ny,
            mid_pad=_ceil_to(ny, p2),
            # c2r's last_fn slices the padded frequency axis itself
            last_true=0 if last_fn is not None else nz,
        )

    return jax.shard_map(local_fn, mesh=mesh, in_specs=in_spec,
                         out_specs=out_spec, check_vma=False)


def make_phase_trials(
    mesh,
    ndim: int,
    params: PlanParams,
    shape: tuple[int, int, int],
    inverse: bool = False,
    rad_z=None,
    rad_y=None,
    rad_x=None,
    k: int = 2,
    first_fn=None,
    last_fn=None,
    z_freq_len: int = 0,
):
    """FAST_TUNING trial programs (offt-compute.c:3538-3548, driver -A
    run-fft.c:219): two shard_map'd sub-programs that execute only the
    FIRST min(k, t) chunks of each pipeline phase, plus per-phase
    extrapolation weights t/k. The tuner times trial1 + trial2 and
    estimates the full transform as w1*t_trial1 + w2*t_trial2 — trial cost
    drops ~t/k while preserving the per-chunk cost structure (the outputs
    are numerically meaningless; only wall time matters).

    ``first_fn``/``last_fn``/``z_freq_len`` mirror make_pencil_fft3d's
    r2c/c2r overrides (the reference's extrapolation wraps the r2c phases
    too): a real-forward trial1 consumes the REAL z-pencil input and runs
    the true fold-kernel per chunk; a c2r trial feeds the half-spectrum.

    Returns ((fn1, in_spec1, in_shape1, w1), (fn2, in_spec2, in_shape2, w2))
    with global input shapes/specs for synthesizing trial operands.
    """
    p1, p2 = mesh_shape(mesh)
    nx, ny, nz = shape
    nzt = z_freq_len or nz
    ax, ay, az = _spatial_axes(ndim)
    batch = _batch_spec(mesh, ndim)
    if not inverse:
        a_first, a_mid, a_last = az, ay, ax
        name1, size1, name2, size2 = COL, p2, ROW, p1
        pad_first, mid_true = _ceil_to(nzt, p2), ny
        mid_pad, last_true = _ceil_to(ny, p1), nx
        rad_first, rad_mid, rad_last = rad_z, rad_y, rad_x
        in_spec = P(*batch, ROW, COL, None)
        mid_spec = P(*batch, ROW, None, COL)
        out_spec = P(*batch, None, ROW, COL)
        in_shape = (_ceil_to(nx, p1), _ceil_to(ny, p2), nz)
        mid_shape = (_ceil_to(nx, p1), ny, pad_first)
    else:
        a_first, a_mid, a_last = ax, ay, az
        name1, size1, name2, size2 = ROW, p1, COL, p2
        pad_first, mid_true = _ceil_to(nx, p1), ny
        mid_pad = _ceil_to(ny, p2)
        # c2r's last_fn slices the padded frequency axis itself
        last_true = 0 if last_fn is not None else nz
        rad_first, rad_mid, rad_last = rad_x, rad_y, rad_z
        in_spec = P(*batch, None, ROW, COL)
        mid_spec = P(*batch, ROW, None, COL)
        out_spec = P(*batch, ROW, COL, None)
        in_shape = (nx, _ceil_to(ny, p1), _ceil_to(nzt, p2))
        mid_shape = (pad_first, ny, _ceil_to(nzt, p2))
    lead = (1,) * (ndim - 3)
    in_shape = lead + in_shape
    mid_shape = lead + mid_shape

    k1 = max(1, min(k, params.t1))
    k2 = max(1, min(k, params.t2))
    do_first = first_fn or (lambda c: axis_fft(c, a_first, inverse,
                                               rad_first, params))
    do_mid = lambda c: axis_fft(c, a_mid, inverse, rad_mid, params)
    do_last = last_fn or (lambda c: axis_fft(c, a_last, inverse,
                                             rad_last, params))

    def local1(xl):
        mid, _, _ = _phase1(
            xl, do_first=do_first, do_mid=do_mid, a_first=a_first,
            a_mid=a_mid, a_last=a_last, name1=name1, size1=size1,
            params=params, pad_first=pad_first, mid_true=mid_true,
            max_chunks=k1)
        return mid

    def local2(ml):
        n_rows = ml.shape[a_last]
        rx = (n_rows * params.ry + 9) // 10 if params.ry < 10 else n_rows
        return _phase2(
            ml, do_mid=do_mid, do_last=do_last, a_first=a_first,
            a_mid=a_mid, a_last=a_last, name2=name2, size2=size2,
            params=params, mid_pad=mid_pad, last_true=last_true,
            rx=rx, n_rows=n_rows, max_chunks=k2)

    fn1 = jax.shard_map(local1, mesh=mesh, in_specs=in_spec,
                        out_specs=mid_spec, check_vma=False)
    fn2 = jax.shard_map(local2, mesh=mesh, in_specs=mid_spec,
                        out_specs=out_spec, check_vma=False)
    return ((fn1, in_spec, in_shape, params.t1 / k1),
            (fn2, mid_spec, mid_shape, params.t2 / k2))
