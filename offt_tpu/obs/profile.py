"""Device timing and per-stage breakdowns.

:func:`time_fn` is the one timer of the package: warm up (which
compiles), then time ``reps`` calls on the host clock, each ending in
``jax.block_until_ready``, and report the median with its spread.

The breakdowns re-express the reference's 17-slot interval-timer array
(offt.h:171-188: ALL/FFTz/FFTy/FFTx/TRANSPOSE/PACK/UNPACK/WAIT...,
bracketed with MPI_Wtime around every stage). One fused XLA program
cannot be bracketed inside, so each stage is jit-compiled *separately*
and timed; stage sums exceed the fused end-to-end time, and the
difference is reported as ``fusion_gain`` / ``overlap_gain``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Timing:
    """Seconds per call of ``reps`` timed calls."""

    times: tuple

    @property
    def median(self) -> float:
        return statistics.median(self.times)

    @property
    def min(self) -> float:
        return min(self.times)

    @property
    def max(self) -> float:
        return max(self.times)

    @property
    def spread(self) -> float:
        """(max - min) / median: the relative spread of the calls."""
        return (self.max - self.min) / self.median


def time_fn(fn: Callable, args: tuple, reps: int = 10,
            warmup: int = 2) -> Timing:
    """Time ``fn(*args)``: ``warmup`` untimed calls, then ``reps`` calls,
    each waited for with ``jax.block_until_ready``. The same inputs are
    re-issued every call (outputs may carry other shardings or shapes)."""
    import jax

    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return Timing(tuple(times))


def fft3d_breakdown(shape, params=None, dtype="complex64",
                    mesh=None) -> dict[str, float]:
    """Per-axis + fused timing (seconds) for a 3-D c2c plan.

    Keys: fft_z / fft_y / fft_x (separately-jitted single-axis passes),
    total_fused (the real plan), stage_sum, fusion_gain. With a mesh, adds
    total_phase1 / total_phase2 style split via t-chunk boundaries is not
    separable under GSPMD; only the fused total is reported per phase
    structure (documented limitation).
    """
    import jax
    import jax.numpy as jnp

    import offt_tpu
    from ..dist.pencil import axis_fft
    from ..plan.params import ProblemSpec, default_params

    if params is None:
        p = 1
        if mesh is not None:
            from ..dist.mesh import mesh_shape
            p = mesh_shape(mesh)[0] * mesh_shape(mesh)[1]
        params = default_params(ProblemSpec(shape=tuple(shape), dtype=dtype,
                                            p=p))
    rng = np.random.default_rng(0)
    re = jax.device_put(rng.standard_normal(shape).astype(np.float32))
    im = jax.device_put(rng.standard_normal(shape).astype(np.float32))
    args = (re, im)
    rads = {2: params.radix_z, 1: params.radix_y, 0: params.radix_x}

    def stage(axis):
        def fn(r, i):
            c = axis_fft(jax.lax.complex(r, i), axis, False, rads[axis],
                         params)
            return jnp.real(c), jnp.imag(c)
        return jax.jit(fn)

    out: dict[str, float] = {}
    if mesh is None:
        out["fft_z"] = time_fn(stage(2), args).median
        out["fft_y"] = time_fn(stage(1), args).median
        out["fft_x"] = time_fn(stage(0), args).median
    plan = offt_tpu.plan(shape, dtype, mesh=mesh, params=params, planar=True)
    out["total_fused"] = time_fn(plan._fn, args).median
    stages = [v for k, v in out.items() if k.startswith("fft_")]
    if stages:
        out["stage_sum"] = sum(stages)
        out["fusion_gain"] = out["stage_sum"] - out["total_fused"]
    return out


def pencil_breakdown(shape, mesh, params=None,
                     dtype="complex64") -> dict[str, float]:
    """Distributed per-phase breakdown (seconds) on a (p1, p2) mesh.

    The reference brackets 17 timer slots inside one execution
    (offt.h:171-188: FFTz/PACK1/WAIT1/UNPACK1/FFTy/... per phase). Under
    GSPMD one fused program is not internally bracketable, so each stage
    is a separately-jitted shard_map'd sub-program over the SAME shardings
    the real pipeline uses:

      fft_z -> exchange_1 (z<->y all_to_all over COL) -> fft_y ->
      exchange_2 (y<->x over ROW) -> fft_x

    ``stage_sum - total_fused`` is the measured fusion/overlap win — the
    counterpart of the overlap the reference's W-window buys
    (offt-compute.c:3614-3647). Requires mesh-divisible extents."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import offt_tpu
    from ..dist.mesh import COL, ROW, mesh_shape
    from ..dist.pencil import _transpose, axis_fft
    from ..plan.params import ProblemSpec, default_params

    nx, ny, nz = shape
    p1, p2 = mesh_shape(mesh)
    if nx % p1 or ny % p2 or ny % p1 or nz % p2:
        raise ValueError(f"breakdown needs mesh-divisible extents, "
                         f"got {shape} on {p1}x{p2}")
    if params is None:
        params = default_params(
            ProblemSpec(shape=tuple(shape), dtype=dtype, p=p1 * p2), p1=p1)

    rng = np.random.default_rng(0)
    spec_in = P(ROW, COL, None)       # z-pencils
    spec_mid = P(ROW, None, COL)      # y-pencils
    spec_out = P(None, ROW, COL)      # x-pencils (transposed out)

    def planar_sm(local_fn, in_spec, out_spec):
        def planar(r, i):
            c = local_fn(jax.lax.complex(r, i))
            return jnp.real(c), jnp.imag(c)
        sm = jax.shard_map(planar, mesh=mesh, in_specs=(in_spec, in_spec),
                           out_specs=(out_spec, out_spec), check_vma=False)
        return jax.jit(sm)

    def args_for(sspec):
        sh = NamedSharding(mesh, sspec)
        re = jax.device_put(rng.standard_normal(shape).astype(np.float32), sh)
        im = jax.device_put(rng.standard_normal(shape).astype(np.float32), sh)
        return re, im

    stages = {
        "fft_z": (lambda c: axis_fft(c, 2, False, params.radix_z, params),
                  spec_in, spec_in),
        "exchange_1": (lambda c: _transpose(c, COL, 2, 1, p2, params.s1,
                                            params.v & 1),
                       spec_in, spec_mid),
        "fft_y": (lambda c: axis_fft(c, 1, False, params.radix_y, params),
                  spec_mid, spec_mid),
        "exchange_2": (lambda c: _transpose(c, ROW, 1, 0, p1, params.s2,
                                            (params.v >> 1) & 1),
                       spec_mid, spec_out),
        "fft_x": (lambda c: axis_fft(c, 0, False, params.radix_x, params),
                  spec_out, spec_out),
    }
    out: dict[str, float] = {}
    for name, (fn, si, so) in stages.items():
        out[name] = time_fn(planar_sm(fn, si, so), args_for(si)).median
    plan = offt_tpu.plan(shape, dtype, mesh=mesh, params=params, planar=True)
    out["total_fused"] = time_fn(plan._fn, args_for(spec_in)).median
    out["stage_sum"] = sum(v for k, v in out.items()
                           if k != "total_fused")
    out["overlap_gain"] = out["stage_sum"] - out["total_fused"]
    return out
