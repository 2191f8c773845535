"""Plan parameters: the JAX re-expression of the reference's 24-knob space.

The reference's ``struct _offt_params`` (/root/reference/offt.h:69-100) has
24 integers: P1 (grid factor), T1/T2 (tile sizes), W1/W2 (overlap windows),
8 pack/unpack cache sub-tile dims, 8 MPI_Test injection frequencies, Ry
(phase work split), V (alltoallv vs padded alltoall), S (strided FFT vs
explicit transpose). Here (SURVEY.md §2c mapping note):

- **P1** survives as the mesh factorization p = P1 x P2.
- **T1/T2, W1/W2** survive as pipeline chunk counts / in-flight depth for the
  two distributed transpose phases.
- **S** survives as the transpose strategy (all_to_all vs ppermute ring).
- **V** survives as exact-vs-padded shard layout (padded-only initially:
  XLA wants static equal shapes).
- **Ry** survives as the fraction of y-FFT work done before vs after the
  second transpose.
- The 8 **F\\*** MPI_Test progress knobs are *dropped*: XLA's collectives
  progress on their own, no manual progress calls exist. The 8 cache
  sub-tile dims are dropped too: XLA and the FFT library own the memory
  hierarchy.
- New knobs: the local engine (XLA's FFT or the matmul chain) and, for the
  matmul chain, per-axis radix factorization and dot precision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..kernels import dft

# Mirrors BUFFER_SIZE_LIMIT (offt.h:51): ceiling on per-device working set,
# expressed in complex64 elements of pipeline scratch (32M elems = 256 MiB).
BUFFER_ELEMS_LIMIT = 32 * 1024 * 1024

TRANSPOSE_ALL_TO_ALL = 0   # single lax.all_to_all per phase
TRANSPOSE_PPERMUTE = 1     # ring of collective_permutes (overlappable)

# local 1-D/n-D transform engine
ENGINE_XLA = "xla"         # jnp.fft / lax.fft (cuFFT on the GPU)
ENGINE_MATMUL = "matmul"   # mixed-radix matmul chain (kernels/stockham.py)
ENGINES = (ENGINE_XLA, ENGINE_MATMUL)
PRECISIONS = ("highest", "high", "default")


@dataclasses.dataclass(frozen=True)
class PlanParams:
    """Tunable execution parameters for one 3-D FFT plan."""

    # decomposition: p = p1 * p2 (p2 == 1 -> slab; p1 == 1 -> "METHOD ONE"
    # analogue, see offt-compute.c:3896-3998)
    p1: int = 1
    # pipeline chunking: number of tiles each transpose phase is split into
    # (1 = no pipelining, analogous to W=0 blocking alltoall, run-fft.c -Q)
    t1: int = 1
    t2: int = 1
    # in-flight window depth per phase (reference W1/W2, offt.h:78-79);
    # with XLA async collectives this bounds concurrently live chunks
    w1: int = 1
    w2: int = 1
    # y-FFT split between phases, in tenths (reference Ry, offt.h:94)
    ry: int = 10
    # transpose strategy per phase (reference S knob generalized)
    s1: int = TRANSPOSE_ALL_TO_ALL
    s2: int = TRANSPOSE_ALL_TO_ALL
    # device->grid assignment (reference ROTATE_RANKORDER,
    # offt-compute.c:69-77): 0 = mesh as given, 1 = row-major
    # enumeration order, 2 = column-major (rotated). Decides which
    # devices share each phase's all_to_all.
    rankorder: int = 0
    # per-phase exchange primitive, 2 bits like the reference V (offt.h:96,
    # alltoallv vs padded alltoall): bit0 = phase 1, bit1 = phase 2;
    # 0 = split all_to_all / ring (see s1/s2), 1 = all_gather + local slice
    # (latency-optimal, bandwidth-heavy — wins on small exchanges)
    v: int = 0
    # local transform engine: "xla" (jnp.fft, which XLA hands to cuFFT on
    # the GPU) or "matmul" (the mixed-radix matmul chain)
    engine: str = ENGINE_XLA
    # matmul engine only: per-axis radix factorization override; None ->
    # dft.factorize default
    radix_z: Optional[tuple[int, ...]] = None
    radix_y: Optional[tuple[int, ...]] = None
    radix_x: Optional[tuple[int, ...]] = None
    # (n1, n2) matrix view of the distributed long-1-D engine
    # (dist/long1d.py, degenerate (1, 1, N) plans on a mesh): N = n1 * n2
    # with the device count dividing both; None = auto (balanced).
    split_1d: Optional[tuple[int, int]] = None
    # matmul engine only: dot precision. 'highest' keeps fp32 operands
    # (meets the 1e-6 bar); 'high' and 'default' let XLA use reduced-
    # precision tensor-core passes (TF32 on the GPU, ~1e-3) for
    # error-tolerant workloads.
    precision: str = "highest"

    def astuple(self) -> tuple:
        return dataclasses.astuple(self)

    def replace(self, **kw) -> "PlanParams":
        return dataclasses.replace(self, **kw)


def w_from_reference(W: int, unbounded: bool = False) -> int:
    """Translate a reference W1/W2 window value (offt.h:78-79) into this
    framework's ``w`` knob — the two are OFF BY ONE and naive cross-reading
    mis-seeds tuners. The reference's W counts nonblocking exchanges issued
    AHEAD of the chunk being completed (W=0 = blocking alltoall, the
    no-overlap path); our ``w`` is the CAP on concurrently-live chunk
    collectives enforced by optimization_barrier chaining
    (dist/pencil.py:_window_tie), where ``w=0`` means NO cap (scheduling
    left entirely to XLA's async scheduler, no reference analogue short of
    W=T). A cap of ``w`` live chunks is the completing chunk plus ``w-1``
    issued ahead, so ``w = W + 1``:

        reference W=0 (blocking)   -> w=1
        reference W=2 (paper pick) -> w=3
        unbounded                  -> w=0
    """
    if unbounded:
        return 0
    if W < 0:
        raise ValueError(f"reference W must be >= 0, got {W}")
    return int(W) + 1


def divisors(n: int) -> list[int]:
    ds = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    return sorted(set(ds + [n // d for d in ds]))


def pow2_grid(lo: int, hi: int, include_zero: bool = False) -> list[int]:
    """The reference's power-of-two value ladders (offt-compute.c:3042-3079)."""
    vals = [0] if include_zero else []
    v = max(lo, 1)
    while v < hi:
        vals.append(v)
        v *= 2
    vals.append(hi)
    return sorted(set(vals))


def p1_candidates(nx: int, ny: int, nz: int, p: int) -> list[int]:
    """Legal decomposition factors, mirroring offt-compute.c:3002-3023.

    p1 must divide p; the row group size p2 = p/p1 must not exceed Ny or Nz
    (each rank needs >=1 plane in every pencil orientation), and p1 must not
    exceed Nx or Ny.
    """
    out = []
    for d in divisors(p):
        p2 = p // d
        if d <= min(nx, ny) and p2 <= min(ny, nz):
            out.append(d)
    return out or [p]


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Static problem description a plan is built for."""

    shape: tuple[int, int, int]
    dtype: str = "complex64"
    real: bool = False          # r2c/c2r transform
    inverse: bool = False
    batch: int = 1
    p: int = 1                  # total device count
    # shard the leading batch axis over all devices instead of the spatial
    # pencil decomposition (zero-collective mode for batch >= p)
    batch_sharded: bool = False

    @property
    def nz_freq(self) -> int:
        """Transform length along z after r2c folding (Nz//2+1)."""
        return self.shape[2] // 2 + 1 if self.real else self.shape[2]


def default_params(spec: ProblemSpec, p1: Optional[int] = None) -> PlanParams:
    """Heuristic default point — the analogue of ``params_set_default``
    (offt-compute.c:3127-3225). This is the baseline the tuner must beat
    by >=20% (BASELINE.md). ``p1`` pins the grid factor (a concrete mesh)."""
    nx, ny, nz = spec.shape
    if p1 is None:
        cands = p1_candidates(nx, ny, nz, spec.p)
        # prefer near-square grid (balanced all_to_all volume per phase)
        root = int(math.sqrt(spec.p))
        p1 = min(cands, key=lambda d: (abs(d - root), d))
    if spec.p == 1:
        return PlanParams(p1=1)
    # Distributed defaults by mesh-size class, like the reference's
    # params_set_default (offt-compute.c:3127-3225). The evidence is from
    # the 8-device virtual CPU mesh, not from GPUs: docs/receipts/
    # knob_sweep_cpu.jsonl + tune_cpu_mesh_summary.jsonl.
    #   p <= 8:  t=4 pipeline chunks win big (2.3x over t=1 at 32x64x256 on
    #            the 2x4 mesh) and w=0 (unbounded in-flight) edges every
    #            bounded window at t=4 (20.1 vs 22.7 ms at w=2).
    #   p >= 16: chunking overhead LOSES once the collectives saturate the
    #            fabric (t=1 23.9 ms vs t=4 24.0/26.4 at 4x4; t=4 never
    #            recovers its dispatch overhead at 4x8) — no pipelining.
    # s (ring) and v (gather) only ever won in the unpipelined t=1 region,
    # which this heuristic avoids; both stay 0.
    p2 = spec.p // p1
    if spec.p >= 16:
        t1 = t2 = 1
    else:
        t1 = min(4, max(1, nx // max(p1, 1)))
        t2 = min(4, max(1, spec.nz_freq // max(p2, 1)))
    if spec.inverse:   # the inverse pipeline chunks z in phase 1, x in phase 2
        t1, t2 = t2, t1
    return PlanParams(p1=p1, t1=t1, t2=t2, w1=0, w2=0)


def infeasible_reason(spec: ProblemSpec, params: PlanParams) -> Optional[str]:
    """Structural feasibility predicate — analogue of ``is_infeasible_point``
    (offt-tuning.c:144-226). Returns a human-readable reason or None."""
    nx, ny, nz = spec.shape
    nzf = spec.nz_freq
    p = spec.p
    if p % params.p1 != 0:
        return f"p1={params.p1} does not divide p={p}"
    p2 = p // params.p1
    # NOTE: the reference also requires p1 <= min(Nx,Ny) and p2 <= min(Ny,Nz)
    # (offt-compute.c:3005-3023) because every rank must own >= 1 plane.
    # Padded static shards lift that: oversubscribed mesh axes just carry
    # garbage planes on the tail devices. p1_candidates stays conservative
    # so the *tuner* doesn't waste trials there.
    # tiles must not exceed the per-device pencil-batch extents they chunk.
    # Orientation matters: the forward pipeline's phase 1 chunks the local
    # x rows and phase 2 the local z planes; the inverse pipeline mirrors
    # (phase 1 chunks z, phase 2 chunks x — dist/pencil.py make_pencil_fft3d)
    m1 = -(-nx // params.p1)            # x rows per device
    m3 = -(-nzf // p2)                  # z planes per device
    b1, b2 = (m3, m1) if spec.inverse else (m1, m3)
    if not (1 <= params.t1 <= max(b1, 1)):
        return f"t1={params.t1} outside [1,{b1}]"
    if not (1 <= params.t2 <= max(b2, 1)):
        return f"t2={params.t2} outside [1,{b2}]"
    if not (0 <= params.w1 <= params.t1):
        return f"w1={params.w1} outside [0,t1]"
    if not (0 <= params.w2 <= params.t2):
        return f"w2={params.w2} outside [0,t2]"
    if not (0 <= params.ry <= 10):
        return f"ry={params.ry} outside [0,10]"
    if params.s1 not in (0, 1) or params.s2 not in (0, 1):
        return "s1/s2 outside {0,1}"
    if not (0 <= params.v <= 3):
        return "v outside [0,3]"
    if params.rankorder not in (0, 1, 2):
        return "rankorder outside {0,1,2}"
    if params.engine not in ENGINES:
        return f"engine {params.engine!r} unknown (one of {ENGINES})"
    if params.precision not in PRECISIONS:
        return f"precision {params.precision!r} unknown"
    if params.engine == ENGINE_XLA and (
            params.precision != "highest"
            or any(r is not None for r in (params.radix_z, params.radix_y,
                                           params.radix_x))):
        # radices and dot precision are matmul-engine knobs; with the XLA
        # engine they would be duplicate search points of the default
        return ("radix_*/precision apply only to engine "
                f"{ENGINE_MATMUL!r}")
    # buffer ceiling, reference BUFFER_SIZE_LIMIT (offt-tuning.c:170,183):
    # per-device working set of one pipelined chunk x window depth. Only
    # meaningful for distributed plans (local plans have no comm buffers).
    if p > 1:
        per_dev = (nx * ny * nzf * max(spec.batch, 1)) / p
        for t, w in ((params.t1, params.w1), (params.t2, params.w2)):
            inflight = (max(w, 1) + 1) * (per_dev / max(t, 1))
            if inflight > BUFFER_ELEMS_LIMIT:
                return "pipeline working set exceeds BUFFER_ELEMS_LIMIT"
    for rad, n in (
        # r2c/c2r runs the packed half-length transform along z
        (params.radix_z, nz // 2 if spec.real else nz),
        (params.radix_y, ny),
        (params.radix_x, nx),
    ):
        if rad is not None:
            prod = 1
            for r in rad:
                prod *= r
            if prod != n or any(r > dft.MAX_RADIX for r in rad):
                return f"radices {rad} invalid for N={n}"
    if params.split_1d is not None:
        from ..dist.long1d import pick_split
        if (nx, ny) != (1, 1):
            return "split_1d applies only to degenerate (1, 1, N) plans"
        # real transforms run the half-length c2c core
        m = nz // 2 if spec.real else nz
        if pick_split(m, params.split_1d) is None:
            return f"split_1d {params.split_1d} invalid for N={m}"
    return None


def is_feasible(spec: ProblemSpec, params: PlanParams) -> bool:
    return infeasible_reason(spec, params) is None
