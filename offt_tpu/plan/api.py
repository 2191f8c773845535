"""Public plan / execute API.

The reference's lifecycle (offt.h:236-244) is

    offt_3d_init(Nx,Ny,Nz,...)  ->  offt_3d_execute(plan,in,out)  ->  offt_3d_fin

Here a :class:`Plan` is an immutable description + a jitted executable; there
is nothing to finalize (XLA owns buffers). ``plan()`` consults the persistent
best-plan cache, falls back to the heuristic default point
(params.default_params, the analogue of offt-compute.c:3127 params_set_default),
and jit-compiles the pipeline with pinned input/output shardings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..dist import mesh as meshlib
from ..dist.pencil import make_pencil_fft3d
from ..kernels.rfft import irfft_1d, pack_last, rfft_1d, unpack_3d, unpack_last
from ..kernels.stockham import _as_complex_dtype
from . import cache
from .params import (ENGINE_XLA, PlanParams, ProblemSpec, default_params,
                     infeasible_reason)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


# ---- planar complex boundary --------------------------------------------
# A "planar" array is the pair (real, imag) of float arrays; plans built
# with planar=True take and return such pairs instead of complex arrays.

def to_planar(x) -> tuple:
    """Split a complex array into the planar (real, imag) float pair."""
    x = jnp.asarray(x)
    return (jnp.real(x), jnp.imag(x))


def from_planar(re, im):
    """Combine a planar pair into a complex array."""
    re = jnp.asarray(re)
    return jax.lax.complex(re, jnp.asarray(im).astype(re.dtype))


def _planarize(fn, in_planar: bool, out_planar: bool):
    """Wrap a complex->complex fn with planar input/output conversion."""
    if not in_planar and not out_planar:
        return fn

    def _post(y):
        if out_planar and jnp.iscomplexobj(y):
            return jnp.real(y), jnp.imag(y)
        return y

    if in_planar:
        def wrapped(re, im):
            return _post(fn(jax.lax.complex(re, im)))
    else:
        def wrapped(x):
            return _post(fn(x))

    return wrapped


def _rfft_z(x, params: PlanParams):
    """Forward r2c along the last axis on the plan's engine (numpy rfft
    layout, N//2+1 bins)."""
    if params.engine == ENGINE_XLA:
        return jnp.fft.rfft(x, axis=-1)
    return rfft_1d(x, axis=-1, radices=params.radix_z,
                   fft_fn=_real_fft_fn(params))


def _irfft_z(x, params: PlanParams, nz: int):
    """Inverse c2r along the last axis to length ``nz`` (numpy irfft)."""
    if params.engine == ENGINE_XLA:
        return jnp.fft.irfft(x, n=nz, axis=-1)
    return irfft_1d(x, n=nz, axis=-1, radices=params.radix_z,
                    fft_fn=_real_fft_fn(params))


def _real_fft_fn(params: PlanParams):
    """Inner c2c of the matmul engine's packed r2c/c2r. radix_z applies
    to the half-length transform; dropped when the inner length differs
    (odd-N full-length fallback)."""
    from ..dist.pencil import axis_fft

    def fn(v, axis, inverse):
        ax = axis % v.ndim
        rad = params.radix_z
        if rad is not None:
            prod = 1
            for r in rad:
                prod *= r
            if prod != v.shape[ax]:
                rad = None
        return axis_fft(v, ax, inverse, rad, params)

    return fn


def _local_fft3d(x, inverse: bool, real: bool, nz: int, params: PlanParams):
    """Single-device transform over the three trailing axes (also the
    per-device body of the batch-sharded path). The XLA engine makes one
    n-D FFT call over the axes longer than 1; the matmul engine makes
    three axis passes."""
    from ..dist.pencil import axis_fft

    ax, ay, az = x.ndim - 3, x.ndim - 2, x.ndim - 1
    if params.engine == ENGINE_XLA:
        axes = [a for a in (ax, ay) if x.shape[a] > 1] + [az]
        if real and inverse:
            s = [x.shape[a] for a in axes[:-1]] + [nz]
            return jnp.fft.irfftn(x, s=s, axes=axes)
        if real:
            return jnp.fft.rfftn(x, axes=axes)
        return (jnp.fft.ifftn if inverse else jnp.fft.fftn)(x, axes=axes)
    if not inverse:
        if real:
            x = _rfft_z(x, params)
        else:
            x = axis_fft(x, az, False, params.radix_z, params)
        x = axis_fft(x, ay, False, params.radix_y, params)
        return axis_fft(x, ax, False, params.radix_x, params)
    x = axis_fft(x, ax, True, params.radix_x, params)
    x = axis_fft(x, ay, True, params.radix_y, params)
    if real:
        return _irfft_z(x, params, nz)
    return axis_fft(x, az, True, params.radix_z, params)


@dataclasses.dataclass
class Plan:
    """A compiled 3-D FFT plan (forward or inverse, c2c or r2c).

    Plans are differentiable in both modes (``jax.grad``, ``jax.vjp``,
    ``jax.jvp``): every pipeline is plain JAX, so JAX's own rules for FFTs
    and collectives apply. ``_fn`` is the jitted executable (has
    ``.lower``)."""

    spec: ProblemSpec
    params: PlanParams
    mesh: Optional[jax.sharding.Mesh]
    ndim: int
    _fn: callable = dataclasses.field(repr=False)
    planar: bool = False
    _in_planar: bool = False
    # non-pencil layouts (the distributed 1-D engine's natural-order flat
    # shardings, the batch-sharded layout): when set, overrides the
    # pencil input/output properties
    _shards: Optional[tuple] = dataclasses.field(repr=False, default=None)

    def __call__(self, x, x_imag=None):
        fn = self._fn
        if self._in_planar:
            if x_imag is None:
                x, x_imag = x  # accept a (re, im) pair as one argument
            return fn(x, x_imag)
        return fn(x)

    execute = __call__

    @property
    def input_sharding(self):
        if self.mesh is None:
            return None
        if self._shards is not None:
            return self._shards[0]
        return (meshlib.output_sharding(self.mesh, self.ndim)
                if self.spec.inverse
                else meshlib.input_sharding(self.mesh, self.ndim))

    @property
    def output_sharding(self):
        if self.mesh is None:
            return None
        if self._shards is not None:
            return self._shards[1]
        return (meshlib.input_sharding(self.mesh, self.ndim)
                if self.spec.inverse
                else meshlib.output_sharding(self.mesh, self.ndim))

    def lower(self, x_shape_dtype):
        return jax.jit(self._fn).lower(x_shape_dtype)


def _pad_axis(x, axis: int, target: int):
    cur = x.shape[axis]
    if cur >= target:
        return x
    padw = [(0, 0)] * x.ndim
    padw[axis] = (0, target - cur)
    return jnp.pad(x, padw)


def _slice_axis(x, axis: int, target: int):
    if x.shape[axis] <= target:
        return x
    return lax.slice_in_dim(x, 0, target, axis=axis)


def real_stage_fns(params: PlanParams, nz: int, packed: bool, inverse: bool,
                   real: bool = True):
    """(first_fn, last_fn) overriding the distributed pipeline's z-stage
    for real transforms (r2c fold forward / c2r unfold inverse) — shared
    by the plan builder and the FAST_TUNING trial builder so trial
    programs carry the true per-chunk r2c cost structure
    (offt-compute.c:3538-3548 wraps the r2c path too)."""
    first_fn = last_fn = None
    if not real:
        return first_fn, last_fn
    nzf = nz // 2 if packed else nz // 2 + 1
    if not inverse:
        def first_fn(c):
            y = _rfft_z(c, params)
            return pack_last(y) if packed else y
    else:
        def last_fn(c):
            c = _slice_axis(c, c.ndim - 1, nzf)  # drop exchange pad
            return _irfft_z(unpack_last(c) if packed else c, params, nz)
    return first_fn, last_fn


def _build_raw(spec: ProblemSpec, params: PlanParams, mesh, ndim: int,
               packed: bool = False):
    """Build the (untraced) transform fn. Returns (fn, in_shard, out_shard);
    shardings are None when unconstrained (padded/uneven boundaries).

    Uneven shapes: any (Nx, Ny, Nz) works on any (p1, p2) mesh — global
    operands are padded to mesh-axis multiples at the jit level and the
    pipeline slices back to true extents before each transform (the
    padded-static-shard answer to the reference's variable-count
    MPI_Ialltoallv, offt.h:109-125).

    ``packed`` (real transforms): the frequency axis stays at M = Nz/2
    packed bins through the whole pipeline — the distributed exchanges
    then move exactly the half-spectrum volume, with no Nyquist-plane
    padding (kernels/rfft.py).
    """
    nx, ny, nz = spec.shape
    ax, ay, az = ndim - 3, ndim - 2, ndim - 1
    nzf = nz // 2 if packed else nz // 2 + 1
    nzt = nzf if spec.real else nz          # z length after the first pass

    if mesh is None:
        def fn(x):
            if packed and spec.inverse:
                x = unpack_3d(x)
            y = _local_fft3d(x, spec.inverse, spec.real, nz, params)
            if packed and not spec.inverse:
                y = pack_last(y)
            return y
        return fn, None, None

    if spec.batch_sharded:
        # batched transforms with batch >= devices: shard the batch axis
        # over the WHOLE mesh and keep each 3-D transform device-local —
        # zero collectives (the spectral-solver fast path of BASELINE
        # config 5; the reference has no analogue)
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = (meshlib.ROW, meshlib.COL)
        spec_b = P(axes, *(None,) * (ndim - 1))
        shard = NamedSharding(mesh, spec_b)

        def local_fn(xl):
            return _local_fft3d(xl, spec.inverse, spec.real, nz, params)

        sm_b = jax.shard_map(local_fn, mesh=mesh, in_specs=spec_b,
                             out_specs=spec_b, check_vma=False)

        def fn(x):
            if not spec.real or spec.inverse:
                x = x.astype(_as_complex_dtype(x.dtype))
            return sm_b(x)

        return fn, shard, shard

    p1, p2 = meshlib.mesh_shape(mesh)
    # axis paddings (no-ops when divisible)
    nxp1 = _ceil_to(nx, p1)
    nyp2 = _ceil_to(ny, p2)
    nyp1 = _ceil_to(ny, p1)
    nztp2 = _ceil_to(nzt, p2)

    first_fn, last_fn = real_stage_fns(params, nz, packed, spec.inverse,
                                       real=spec.real)

    sm = make_pencil_fft3d(
        mesh, ndim, params, shape=(nx, ny, nz), inverse=spec.inverse,
        rad_z=None if spec.real else params.radix_z,
        rad_y=params.radix_y, rad_x=params.radix_x,
        first_fn=first_fn, last_fn=last_fn,
        z_freq_len=nzf if spec.real else 0,
    )

    if not spec.inverse:
        # input z-pencils (x/p1, y/p2, z) -> transposed-out (x, y/p1, z'/p2)
        def fwd(x):
            if not (spec.real and not spec.inverse):
                x = x.astype(_as_complex_dtype(x.dtype))
            x = _pad_axis(x, ax, nxp1)
            x = _pad_axis(x, ay, nyp2)
            y = sm(x)
            y = _slice_axis(y, ay, ny)
            y = _slice_axis(y, az, nzt)
            return y

        in_shard = (meshlib.input_sharding(mesh, ndim)
                    if nx == nxp1 and ny == nyp2 else None)
        out_shard = (meshlib.output_sharding(mesh, ndim)
                     if ny == nyp1 and nzt == nztp2 else None)
        return fwd, in_shard, out_shard

    # inverse: transposed-in (x, y/p1, z'/p2) -> z-pencils (x/p1, y/p2, z)
    def inv(x):
        if not spec.real:
            x = x.astype(_as_complex_dtype(x.dtype))
        x = _pad_axis(x, ay, nyp1)
        x = _pad_axis(x, az, nztp2)
        y = sm(x)
        y = _slice_axis(y, ax, nx)
        y = _slice_axis(y, ay, ny)
        return y

    in_shard = (meshlib.output_sharding(mesh, ndim)
                if ny == nyp1 and nzt == nztp2 else None)
    out_shard = (meshlib.input_sharding(mesh, ndim)
                 if nx == nxp1 and ny == nyp2 else None)
    return inv, in_shard, out_shard


def _jit_plan_fn(spec: ProblemSpec, raw_fn, in_shard, out_shard,
                 planar: bool, donate: bool = False):
    """Planarize (if requested) and jit with pinned shardings.

    With ``planar=True`` complex operands/results cross the jit boundary as
    (real, imag) float pairs. ``donate`` donates the input buffers to XLA
    (the caller's arrays are invalidated), which lets the largest
    transforms reuse the input's memory."""
    in_planar = planar and not (spec.real and not spec.inverse)
    out_planar = planar and not (spec.real and spec.inverse)
    fn = _planarize(raw_fn, in_planar, out_planar)
    kw = {}
    if in_shard is not None:
        kw["in_shardings"] = (in_shard, in_shard) if in_planar else in_shard
    if out_shard is not None:
        kw["out_shardings"] = (out_shard, out_shard) if out_planar else out_shard
    if donate:
        kw["donate_argnums"] = (0, 1) if in_planar else (0,)
    return jax.jit(fn, **kw), in_planar


def _build_fn(spec: ProblemSpec, params: PlanParams, mesh, ndim: int,
              planar: bool = False, out_scale: float = 1.0,
              packed: bool = False, donate: bool = False):
    def _scaled(fn_inner):
        if out_scale == 1.0:
            return fn_inner

        def wrapped(*a):
            return fn_inner(*a) * out_scale
        return wrapped

    # distributed long-1-D: a degenerate (1, 1, n) plan on a mesh rides
    # the four-step engine over ALL devices (dist/long1d.py) when a
    # P-divisible split exists — natural-order flat in/out shardings
    # (NOT the pencil layouts; returned so the Plan reports them). Real
    # transforms ride the half-length c2c + distributed Hermitian
    # untangle, in the packed layout only.
    if (mesh is not None and not spec.batch_sharded
            and spec.shape[0] == 1 and spec.shape[1] == 1):
        built = None
        if spec.real and packed:
            from ..dist.long1d import make_dist_rfft1d
            built = make_dist_rfft1d(mesh, spec.shape[2], ndim, params,
                                     spec.inverse, dtype=spec.dtype,
                                     out_scale=out_scale)
        elif not spec.real:
            from ..dist.long1d import make_dist_fft1d
            built = make_dist_fft1d(mesh, spec.shape[2], ndim, params,
                                    spec.inverse, dtype=spec.dtype,
                                    out_scale=out_scale)
        if built is not None:
            raw_fn, in_shard, out_shard = built
            fn, in_planar = _jit_plan_fn(spec, raw_fn, in_shard, out_shard,
                                         planar, donate=donate)
            return fn, in_planar, (in_shard, out_shard)

    raw_fn, in_shard, out_shard = _build_raw(spec, params, mesh, ndim,
                                             packed=packed)
    fn, in_planar = _jit_plan_fn(spec, _scaled(raw_fn), in_shard, out_shard,
                                 planar, donate=donate)
    # the batch-sharded layout is not the pencil one: report it
    return fn, in_planar, ((in_shard, out_shard) if spec.batch_sharded
                           else None)


def _norm_scale(norm: str, inverse: bool, total: int) -> float:
    """numpy norm conventions: backward (default) scales the inverse by
    1/N; ortho scales both by 1/sqrt(N); forward scales the forward by
    1/N. Internally the pipelines are backward-normalized, so this returns
    the extra output factor to apply (1.0 = none)."""
    import math
    if norm in (None, "backward"):
        return 1.0
    if norm == "ortho":
        return math.sqrt(total) if inverse else 1.0 / math.sqrt(total)
    if norm == "forward":
        return float(total) if inverse else 1.0 / total
    raise ValueError(f"norm must be backward|ortho|forward, got {norm!r}")


def plan(
    shape: tuple[int, int, int],
    dtype="complex64",
    *,
    mesh: Optional[jax.sharding.Mesh] = None,
    real: bool = False,
    inverse: bool = False,
    batch_dims: int = 0,
    params: Optional[PlanParams] = None,
    use_cache: bool = True,
    planar: bool = False,
    norm: Optional[str] = None,
    batch_sharded: bool = False,
    packed: bool = False,
    donate: bool = False,
) -> Plan:
    """Build a 3-D FFT plan. ``shape`` is the spatial (Nx, Ny, Nz).

    ``planar=True`` moves complex operands/results across the jit boundary
    as (real, imag) float pairs (the split/combine is fused by XLA).
    ``norm`` follows numpy (backward | ortho | forward).

    ``packed=True`` (real transforms, planar) uses the packed
    half-spectrum layout: (..., Nz/2) with bin 0 carrying bin0 + i*binM,
    so distributed exchanges move exactly Nz/2 bins per pencil. Convert
    with ``offt_tpu.pack_rfft3d`` / ``offt_tpu.unpack_rfft3d``.
    """
    if len(shape) != 3:
        raise ValueError(f"shape must be (Nx, Ny, Nz), got {shape}")
    if batch_sharded and (mesh is None or batch_dims < 1):
        raise ValueError("batch_sharded needs a mesh and batch_dims >= 1")
    if packed and (not real or not planar or batch_sharded):
        raise ValueError("packed layout requires real=True, planar=True "
                         "(and not batch_sharded)")
    if packed and shape[2] % 2:
        raise ValueError(f"packed layout needs an even Nz (got {shape[2]})")
    # spatial device count: the pencil decomposition spans only the
    # (ROW, COL) axes; a batch-group slice axis shards batch, not space
    p = 1 if mesh is None else (
        meshlib.mesh_shape(mesh)[0] * meshlib.mesh_shape(mesh)[1])
    # real transforms accept the REAL dtype (FFTW r2c convention) and
    # normalize to the transform's complex dtype — every fast-path gate
    # keys on the complex name, so an unnormalized "float32" would
    # silently route r2c onto the unfused fallback (and break packed=True)
    dt = jnp.dtype(dtype)
    if real and dt.kind == "f":
        # only float64 promotes to the fp64 pipeline; float32 AND the
        # half precisions (float16/bfloat16) map to complex64 — the
        # transform accumulates in f32 regardless of storage precision
        dt = jnp.dtype("complex128" if dt == jnp.dtype("float64")
                       else "complex64")
    spec = ProblemSpec(shape=tuple(shape), dtype=str(dt),
                       real=real, inverse=inverse, p=p,
                       batch_sharded=batch_sharded)
    if params is None and use_cache:
        if mesh is not None:
            p1, p2 = meshlib.mesh_shape(mesh)
            dev_kind = mesh.devices.flat[0].device_kind
        else:
            p1 = p2 = 1
            dev_kind = jax.devices()[0].device_kind
        params = cache.lookup(
            cache.plan_key(shape, spec.dtype, real, p1, p2, dev_kind,
                           inverse=inverse, batch_sharded=batch_sharded))
    if params is None:
        params = default_params(
            spec, p1=None if mesh is None else meshlib.mesh_shape(mesh)[0])
    reason = infeasible_reason(spec, params)
    if reason is not None:
        raise ValueError(f"infeasible plan: {reason}")
    if mesh is not None and params.rankorder:
        # re-grid the caller's devices per the rankorder knob (reference
        # ROTATE_RANKORDER, offt-compute.c:69-77); the Plan carries the
        # re-gridded mesh so its shardings stay self-consistent
        mesh = meshlib.with_rankorder(mesh, params.rankorder)
    ndim = batch_dims + 3
    scale = _norm_scale(norm, inverse, shape[0] * shape[1] * shape[2])
    fn, in_planar, shards = _build_fn(spec, params, mesh, ndim, planar=planar,
                                      out_scale=scale, packed=packed,
                                      donate=donate)
    return Plan(spec=spec, params=params, mesh=mesh, ndim=ndim, _fn=fn,
                planar=planar, _in_planar=in_planar, _shards=shards)


# ---- one-shot conveniences (plans are cached per call-signature by jit) ----

def fft3d(x, mesh=None, params=None, **kw):
    nd = x.ndim
    p = plan(x.shape[nd - 3:], x.dtype, mesh=mesh, params=params,
             batch_dims=nd - 3, **kw)
    return p(x)


def ifft3d(x, mesh=None, params=None, **kw):
    nd = x.ndim
    p = plan(x.shape[nd - 3:], x.dtype, mesh=mesh, params=params,
             inverse=True, batch_dims=nd - 3, **kw)
    return p(x)


def rfft3d(x, mesh=None, params=None, **kw):
    nd = x.ndim
    p = plan(x.shape[nd - 3:], x.dtype, mesh=mesh, params=params,
             real=True, batch_dims=nd - 3, **kw)
    return p(x)


def irfft3d(x, nz: Optional[int] = None, mesh=None, params=None, **kw):
    nd = x.ndim
    nzf = x.shape[-1]
    nz = nz if nz is not None else 2 * (nzf - 1)
    shape = (x.shape[nd - 3], x.shape[nd - 2], nz)
    p = plan(shape, x.dtype, mesh=mesh, params=params, real=True,
             inverse=True, batch_dims=nd - 3, **kw)
    return p(x)


# ---- 2-D transforms (same pipelines, one axis fewer; distributed via the
# METHOD-ONE analogue: a 1-D decomposition on a (1, p) mesh, where the
# degenerate x axis makes phase 2's exchange trivial —
# offt-compute.c:3896-3950)

def fft2d(x, params=None, mesh=None, **kw):
    """2-D c2c FFT over the last two axes.

    Single device: one 2-D transform on the plan's engine.
    Distributed: pass a ``make_mesh(1, p)`` mesh — rows are y-sharded,
    the single pencil exchange transposes y<->z over the COL axis, and
    the result comes back z-sharded (transposed-out layout, like the 3-D
    pipeline). Any leading axes are replicated batch."""
    nd = x.ndim
    shape3 = (1,) + tuple(x.shape[nd - 2:])
    p = plan(shape3, x.dtype, params=params, mesh=mesh,
             batch_dims=nd - 2, **kw)
    return p(x.reshape(x.shape[:nd - 2] + shape3)).reshape(x.shape)


def ifft2d(x, params=None, mesh=None, **kw):
    nd = x.ndim
    shape3 = (1,) + tuple(x.shape[nd - 2:])
    p = plan(shape3, x.dtype, params=params, mesh=mesh, inverse=True,
             batch_dims=nd - 2, **kw)
    return p(x.reshape(x.shape[:nd - 2] + shape3)).reshape(x.shape)


def rfft2d(x, params=None, mesh=None, **kw):
    """2-D r2c over the last two axes: real (..., Y, N) -> complex
    (..., Y, N//2+1) (numpy rfft2 layout; ``packed=True`` keeps the
    M = N/2 packed half-spectrum). Distributed like :func:`fft2d`."""
    nd = x.ndim
    shape3 = (1,) + tuple(x.shape[nd - 2:])
    p = plan(shape3, x.dtype, params=params, mesh=mesh, real=True,
             batch_dims=nd - 2, **kw)
    y = p(x.reshape(x.shape[:nd - 2] + shape3))
    yshape = y.shape if not isinstance(y, tuple) else y[0].shape
    out2 = x.shape[:nd - 2] + yshape[-2:]
    if isinstance(y, tuple):                    # planar pair
        return y[0].reshape(out2), y[1].reshape(out2)
    return y.reshape(out2)


def irfft2d(x, n: Optional[int] = None, params=None, mesh=None, **kw):
    """2-D c2r over the last two axes (inverse of :func:`rfft2d`)."""
    nd = x.ndim
    nzf = x.shape[-1]
    n = n if n is not None else 2 * (nzf - 1)
    shape3 = (1, x.shape[nd - 2], n)
    p = plan(shape3, x.dtype, params=params, mesh=mesh, real=True,
             inverse=True, batch_dims=nd - 2, **kw)
    y = p(x.reshape(x.shape[:nd - 2] + (1,) + x.shape[nd - 2:]))
    return y.reshape(x.shape[:nd - 2] + (x.shape[nd - 2], n))
