"""Distributed long-1-D FFT: the four-step factorization over the mesh.

The reference is a distributed 3-D library whose 1-D engines are local
FFTW sub-plans (``setup_p1d``, offt-compute.c:329-489); a single 1-D
transform bigger than one device's appetite has no reference analogue.
This module spreads the four-step factorization across the mesh: view
n = n1 * n2 as an (n1, n2) matrix, shard it over ALL mesh devices (the
flattened (ROW, COL) axis, P = p1*p2), and run two local axis transforms
(the plan's engine, ``pencil.axis_fft``) between three tunable pencil
exchanges:

    natural rows   (n1/P, n2)            [flat x, contiguous shards]
      --a2a #1 (split n2, concat n1)-->  (n1, n2/P)
    step 1+2: FFT_n1 along axis -2, then the twiddle T[k1, j2]
      --a2a #2 (split n1, concat n2)-->  (n1/P, n2)
    step 3+4: FFT_n2 along axis -1, then a local transpose -> (n2, n1/P)
      --a2a #3 (split n2, concat n1)-->  (n2/P, n1)
    ravel = natural-order X              [flat X, contiguous shards]

With j = j1*n2 + j2 and k = k1 + n1*k2,

    X[k1 + n1*k2] = FFT_{j2->k2}( w^(j2*k1) * FFT_{j1->k1}(x)[k1, j2] )

so the output matrix viewed (n2, n1) row-major IS the natural-order
spectrum, and contiguous row shards of it are contiguous shards of X.

Every exchange is ``pencil._transpose``, so the s (all_to_all vs
ppermute ring) and v (all_gather+slice) strategy knobs apply unchanged;
exchanges #1/#2 take the phase-1 knobs (s1, v bit 0) and #3 the phase-2
knobs (s2, v bit 1). The twiddle T[k1, j2] = w_n^(k1*j2) (norm scaling
folded in) enters as a column-sharded shard_map operand so each device
holds exactly its chunk — no replicated (n1, n2) table anywhere.

Both input and output are NATURAL order (contiguous 1/P chunks of the
flat vector over the linearized device order): unlike the 3-D pencil
pipeline there is no transposed-out layout to track, at the price of
exchange #1 (input redistribution) and #3 (output ordering). Forward
and inverse are the same dataflow with conjugated tables.

Real transforms (``make_dist_rfft1d``) ride the half-length complex
transform: z[j] = x[2j] + i*x[2j+1] (a LOCAL pairing on natural shards),
the same c2c core at M = n/2, then the Hermitian untangle
X[k] = E[k] + w_n^k O[k] DISTRIBUTED — conj(Z[M-k]) is a global mirror,
two single-hop ppermutes (full flip to the mirror device + a one-slot
rotate for the (M-k) mod M wrap). The half-spectrum stays in the PACKED
layout (M bins, bin 0 = DC + i*Nyquist) so it remains natural-sharded
flat; c2r inverts the same path. No reference analogue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..kernels import dft
from ..plan.params import PlanParams
from .mesh import COL, ROW, SLICE, mesh_shape
from .pencil import _transpose, axis_fft


def pick_split(n: int, split=None, divisor: int = 1):
    """Choose the (n1, n2) matrix view with n1 * n2 == n, both factors
    above 1 and divisible by ``divisor`` (the device count: the engine
    shards both matrix axes, so its exchanges need equal static shards),
    or None. An explicit ``split`` (the split_1d knob) is validated only.
    Auto: the most balanced pair, small factor first."""
    def _ok(a, b):
        return a > 1 and b > 1 and a % divisor == 0 and b % divisor == 0

    if split is not None:
        n1, n2 = int(split[0]), int(split[1])
        return (n1, n2) if n1 * n2 == n and _ok(n1, n2) else None
    for d in range(int(np.sqrt(n)), 1, -1):
        if n % d == 0 and _ok(d, n // d):
            return d, n // d
    return None


def dist1d_split(mesh, n: int, params: PlanParams):
    """The (n1, n2) split a distributed 1-D plan would use on ``mesh``,
    or None when ineligible (no split with P | n1 and P | n2, a
    batch-group mesh, or a single device)."""
    if mesh is None or SLICE in mesh.axis_names:
        return None
    p1, p2 = mesh_shape(mesh)
    ptot = p1 * p2
    if ptot <= 1:
        return None
    return pick_split(n, params.split_1d, divisor=ptot)


def natural_sharding(mesh, ndim: int) -> NamedSharding:
    """Flat natural-order layout for (..., 1, 1, n) operands: the last
    axis in contiguous chunks over the linearized (ROW, COL) device
    order. Used for BOTH input and output (module docstring)."""
    spec = (None,) * (ndim - 1) + ((ROW, COL),)
    return NamedSharding(mesh, P(*spec))


def _real_dt(dtype: str):
    return np.float64 if dtype == "complex128" else np.float32


def _make_core(mesh, m: int, params: PlanParams, inverse: bool,
               dtype: str, out_scale: float):
    """The shared c2c core: returns ``(local_c2c, (n1, n2), tw_host)``
    or None. ``local_c2c(xm, twr, twi)`` maps one device's natural
    matrix-row chunk (B..., n1/P, n2) to its natural output chunk
    (B..., n2/P, n1) — callable only inside a shard_map over ``mesh``
    with the twiddle operands column-sharded P(None, (ROW, COL))."""
    sp = dist1d_split(mesh, m, params)
    if sp is None:
        return None
    p1, p2 = mesh_shape(mesh)
    ptot = p1 * p2
    n1, n2 = sp
    names = (ROW, COL)

    # the axis_fft passes apply numpy ifft semantics (1/n1 then 1/n2 =
    # 1/m), so the twiddle table carries only the norm's out_scale
    t = dft.twiddles(n1, n2, np.complex128, inverse) * out_scale
    rdt = _real_dt(dtype)
    tw_host = (np.ascontiguousarray(t.real.astype(rdt)),
               np.ascontiguousarray(t.imag.astype(rdt)))

    def local_c2c(xl, twr, twi):
        a_r, a_c = xl.ndim - 2, xl.ndim - 1
        # xl: (B..., n1/P, n2) — natural contiguous row chunk
        xl = _transpose(xl, names, split_axis=a_c, concat_axis=a_r,
                        size=ptot, strategy=params.s1,
                        variant=params.v & 1)
        z = axis_fft(xl, a_r, inverse, None, params)
        z = z * lax.complex(twr, twi)
        z = _transpose(z, names, split_axis=a_r, concat_axis=a_c,
                       size=ptot, strategy=params.s1,
                       variant=params.v & 1)
        y = axis_fft(z, a_c, inverse, None, params)
        y = jnp.swapaxes(y, -1, -2)
        return _transpose(y, names, split_axis=a_r, concat_axis=a_c,
                          size=ptot, strategy=params.s2,
                          variant=(params.v >> 1) & 1)

    return local_c2c, (n1, n2), tw_host


def make_dist_fft1d(mesh, n: int, ndim: int, params: PlanParams,
                    inverse: bool, dtype: str = "complex64",
                    out_scale: float = 1.0):
    """Build the natural-order distributed 1-D c2c transform.

    Returns ``(fn, in_sharding, out_sharding)`` — fn maps complex
    (..., 1, 1, n) to complex (..., 1, 1, n) (numpy fft/ifft semantics;
    inverse includes 1/n) — or None when the mesh/length is ineligible
    (the caller falls back to the degenerate pencil path).
    """
    core = _make_core(mesh, n, params, inverse, dtype, out_scale)
    if core is None:
        return None
    local_c2c, (n1, n2), tw_host = core
    nbatch = ndim - 3
    bspec = (None,) * nbatch
    names = (ROW, COL)

    sm = jax.shard_map(local_c2c, mesh=mesh,
                       in_specs=(P(*bspec, names, None), P(None, names),
                                 P(None, names)),
                       out_specs=P(*bspec, names, None), check_vma=False)
    cdt = jnp.dtype(dtype)

    def fn(x):
        x = x.astype(cdt)
        lead = x.shape[:-3]
        # flat-natural -> (n1, n2) rows is layout-preserving (row-major
        # ravel), so GSPMD propagates the sharding with zero collectives
        y = sm(x.reshape(lead + (n1, n2)), jnp.asarray(tw_host[0]),
               jnp.asarray(tw_host[1]))
        return y.reshape(lead + (1, 1, n))

    shard = natural_sharding(mesh, ndim)
    return fn, shard, shard


def _mirror(z, names, ptot: int, mloc: int):
    """zr[k] = Z[(M - k) mod M] on natural flat shards: a global flip is
    a local reverse + one hop to the mirror device; the (M-k) mod M wrap
    is a one-slot global rotate = one more single-hop ppermute of a
    single boundary element."""
    ax = z.ndim - 1
    rev = lax.rev(z, (ax,))
    if ptot > 1:
        rev = lax.ppermute(rev, names,
                           [(s, ptot - 1 - s) for s in range(ptot)])
    last = lax.slice_in_dim(rev, mloc - 1, mloc, axis=ax)
    if ptot > 1:
        last = lax.ppermute(last, names,
                            [(s, (s + 1) % ptot) for s in range(ptot)])
    return jnp.concatenate(
        [last, lax.slice_in_dim(rev, 0, mloc - 1, axis=ax)], axis=ax)


def make_dist_rfft1d(mesh, n: int, ndim: int, params: PlanParams,
                     inverse: bool, dtype: str = "complex64",
                     out_scale: float = 1.0):
    """Distributed 1-D real transform in the PACKED half-spectrum layout.

    Forward: real (..., 1, 1, n) float -> complex (..., 1, 1, M = n/2)
    packed (bin 0 = DC + i*Nyquist; bins 1..M-1 = rfft bins). Inverse
    takes the packed half-spectrum back to the real field (numpy irfft
    semantics incl. 1/n). Returns ``(fn, in_sharding, out_sharding)`` or
    None when ineligible (odd n, or no P-divisible split of M).

    Derivation (module docstring): with z[j] = x[2j] + i*x[2j+1] and
    Z = DFT_M(z): E[k] = (Z[k] + conj(Z[M-k]))/2, O[k] = -i/2 *
    (Z[k] - conj(Z[M-k])), X[k] = E[k] + w_n^k O[k], X[M] = E[0] - O[0].
    The conj(Z[M-k]) mirror is two single-hop ppermutes. out_scale folds
    into the INNER c2c twiddle (everything downstream is linear in Z).
    """
    if n % 2:
        return None
    m = n // 2
    core = _make_core(mesh, m, params, inverse, dtype, out_scale)
    if core is None:
        return None
    local_c2c, (n1, n2), tw_host = core
    p1, p2 = mesh_shape(mesh)
    ptot = p1 * p2
    if m % ptot:
        return None
    mloc = m // ptot
    names = (ROW, COL)
    nbatch = ndim - 3
    bspec = (None,) * nbatch
    cdt = jnp.dtype(dtype)
    rdt = _real_dt(dtype)

    # untangle twiddle w_n^k, k = 0..M-1, natural-sharded flat
    k = np.arange(m, dtype=np.float64)
    u = np.exp(-2j * np.pi * k / n)
    u_host = (u.real.astype(rdt), u.imag.astype(rdt))

    def _mask0(xshape):
        # True exactly at global bin 0 (local slot 0 on linear device 0)
        pos = jax.lax.broadcasted_iota(jnp.int32, xshape, len(xshape) - 1)
        return (pos == 0) & (lax.axis_index(names) == 0)

    if not inverse:
        def local_fn(zm, twr, twi, ukr, uki):
            # zm: (B..., n1/P, n2) natural rows of the half-length z
            y = local_c2c(zm, twr, twi)
            lead = y.shape[:-2]
            z = y.reshape(lead + (mloc,))
            zr = _mirror(z, names, ptot, mloc)
            e = 0.5 * (z + jnp.conj(zr))
            o = -0.5j * (z - jnp.conj(zr))
            x = e + lax.complex(ukr, uki) * o
            # packed bin 0: DC + i*Nyquist = (E0 + O0) + i*(E0 - O0)
            # (E0, O0 are real); only valid on device 0 slot 0, where
            # the mirror is the identity so e/o there ARE E0/O0
            packed0 = lax.complex(jnp.real(e) + jnp.real(o),
                                  jnp.real(e) - jnp.real(o))
            return jnp.where(_mask0(x.shape), packed0, x)

        sm = jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(*bspec, names, None), P(None, names),
                      P(None, names), P(names), P(names)),
            out_specs=P(*bspec, names), check_vma=False)

        def fn(x):
            lead = x.shape[:-3]
            # even/odd pairing is LOCAL on natural shards: (n,) ->
            # (M, 2) keeps contiguous chunks aligned (P | M)
            xp = x.astype(rdt).reshape(lead + (m, 2))
            z = lax.complex(xp[..., 0], xp[..., 1]).astype(cdt)
            y = sm(z.reshape(lead + (n1, n2)), jnp.asarray(tw_host[0]),
                   jnp.asarray(tw_host[1]), jnp.asarray(u_host[0]),
                   jnp.asarray(u_host[1]))
            return y.reshape(lead + (1, 1, m))

        in_shard = natural_sharding(mesh, ndim)
        return fn, in_shard, in_shard

    # inverse (c2r): packed half-spectrum -> real field
    n1l = n1 // ptot

    def local_fn(xp, twr, twi, ukr, uki):
        lead = xp.shape[:-1]
        m0 = _mask0(xp.shape)
        dc = jnp.real(xp)          # valid at bin 0 only (masked use)
        ny = jnp.imag(xp)
        xt = jnp.where(m0, lax.complex(dc, jnp.zeros_like(dc)), xp)
        cm = jnp.conj(_mirror(xt, names, ptot, mloc))
        # conj(X[(M-k) mod M]) needs conj(X[M]) = Nyquist at k = 0
        cm = jnp.where(m0, lax.complex(ny, jnp.zeros_like(ny)), cm)
        e = 0.5 * (xt + cm)
        uk = lax.complex(ukr, uki)
        o = 0.5 * jnp.conj(uk) * (xt - cm)
        z = e + 1j * o.astype(e.dtype)
        # natural flat chunk -> the core's (n1/P, n2) local matrix rows
        y = local_c2c(z.reshape(lead + (n1l, n2)), twr, twi)
        return y.reshape(lead + (mloc,))

    sm = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(*bspec, names), P(None, names), P(None, names),
                  P(names), P(names)),
        out_specs=P(*bspec, names), check_vma=False)

    def fn(x):
        x = x.astype(cdt)
        lead = x.shape[:-3]
        z = sm(x.reshape(lead + (m,)), jnp.asarray(tw_host[0]),
               jnp.asarray(tw_host[1]), jnp.asarray(u_host[0]),
               jnp.asarray(u_host[1]))
        # de-interleave: x[2j] = Re z[j], x[2j+1] = Im z[j] — local on
        # natural shards, like the forward pairing
        out = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
        return out.reshape(lead + (1, 1, n))

    shard = natural_sharding(mesh, ndim)
    return fn, shard, shard
