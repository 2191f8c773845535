"""Chip smoke test: offt's main path once on the GPU, at real widths.

    python chip_smoke.py           # one card: phases a-h
    python chip_smoke.py --multi   # four cards: the distributed phases only

Every transform runs through the entry points a user calls (``plan``,
``offt_tpu.fft``, ``tune``, ``offt-bench``) and is compared with numpy's
float64 FFT (scipy.fft with all host cores, the same pocketfft). Each
check prints one line: the relative L2 error against its bar (1e-6 for
complex64/float32, 1e-12 for complex128), the median time of 10 calls
after warm-up (each ending in block_until_ready), and the same transform
through jnp.fft timed in this process. Then the cards' names and power
limits (nvidia-smi), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Exits non-zero, printing no last line, when JAX finds no GPU or any
check fails. One process drives every card it uses.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import traceback

import numpy as np

F32_TOL = 1e-6
F64_TOL = 1e-12


def _ref():
    """Host float64 FFT on all cores (numpy's algorithm, threaded)."""
    try:
        import scipy.fft as sf
        return lambda f, *a, **kw: getattr(sf, f)(*a, workers=-1, **kw)
    except ImportError:
        return lambda f, *a, **kw: getattr(np.fft, f)(*a, **kw)


REF = _ref()


def rel_l2(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm((got - want).ravel())
                 / np.linalg.norm(want.ravel()))


def _timings(fn, args, xla_fn=None, xla_args=None):
    from offt_tpu.obs.profile import time_fn

    t = time_fn(fn, args)
    t_ref = time_fn(xla_fn, xla_args or args) if xla_fn is not None else None
    return t, t_ref


def report(name, err, tol, t=None, t_ref=None) -> bool:
    ok = bool(np.isfinite(err) and err <= tol)
    line = f"{name}: rel_l2={err:.3e} (bar {tol:.0e})"
    if t is not None:
        line += f" t={t.median * 1e3:.4f} ms spread={t.spread:.3f}"
    if t_ref is not None:
        line += f" jnp.fft={t_ref.median * 1e3:.4f} ms"
    print(line + ("  OK" if ok else "  FAIL"), flush=True)
    return ok


def _rand(rng, shape, dtype):
    if np.dtype(dtype).kind == "c":
        rdt = np.float64 if np.dtype(dtype) == np.complex128 else np.float32
        return (rng.standard_normal(shape, dtype=rdt)
                + 1j * rng.standard_normal(shape, dtype=rdt)).astype(dtype)
    return rng.standard_normal(shape, dtype=np.dtype(dtype))


# ---- one-card phases ------------------------------------------------------

def phase_c2c(n=512):
    """a. the reference's own job: n^3 c2c forward and inverse, at the
    complex and the planar boundary."""
    import jax
    import jax.numpy as jnp

    import offt_tpu

    shape = (n, n, n)
    x = _rand(np.random.default_rng(0), shape, np.complex64)
    want = REF("fftn", x.astype(np.complex128))
    xd = jax.device_put(x)
    wd = jax.device_put(want.astype(np.complex64))
    ok = True
    pf = offt_tpu.plan(shape, "complex64")
    pi = offt_tpu.plan(shape, "complex64", inverse=True)
    t, tr = _timings(pf._fn, (xd,), jax.jit(jnp.fft.fftn))
    ok &= report(f"a c2c {n}^3 fwd complex", rel_l2(pf(xd), want),
                 F32_TOL, t, tr)
    t, tr = _timings(pi._fn, (wd,), jax.jit(jnp.fft.ifftn))
    ok &= report(f"a c2c {n}^3 inv complex", rel_l2(pi(wd), x), F32_TOL,
                 t, tr)
    pfp = offt_tpu.plan(shape, "complex64", planar=True)
    pip = offt_tpu.plan(shape, "complex64", inverse=True, planar=True)
    xr, xi = jax.device_put(x.real.copy()), jax.device_put(x.imag.copy())
    yr, yi = pfp(xr, xi)
    t = _timings(pfp._fn, (xr, xi))[0]
    ok &= report(f"a c2c {n}^3 fwd planar",
                 rel_l2(np.asarray(yr) + 1j * np.asarray(yi), want),
                 F32_TOL, t)
    br, bi = pip(yr, yi)
    t = _timings(pip._fn, (yr, yi))[0]
    ok &= report(f"a c2c {n}^3 inv planar (round trip)",
                 rel_l2(np.asarray(br) + 1j * np.asarray(bi), x), F32_TOL, t)
    return ok


def phase_real(n=512):
    """b. n^3 r2c and c2r, in the numpy layout and packed."""
    import jax
    import jax.numpy as jnp

    import offt_tpu

    shape = (n, n, n)
    x = _rand(np.random.default_rng(1), shape, np.float32)
    want = REF("rfftn", x.astype(np.float64))
    xd = jax.device_put(x)
    wd = jax.device_put(want.astype(np.complex64))
    ok = True
    pf = offt_tpu.plan(shape, "float32", real=True)
    pi = offt_tpu.plan(shape, "complex64", real=True, inverse=True)
    t, tr = _timings(pf._fn, (xd,), jax.jit(jnp.fft.rfftn))
    ok &= report(f"b r2c {n}^3 numpy layout", rel_l2(pf(xd), want),
                 F32_TOL, t, tr)
    t, tr = _timings(pi._fn, (wd,),
                     jax.jit(lambda v: jnp.fft.irfftn(v, s=shape)))
    ok &= report(f"b c2r {n}^3 numpy layout", rel_l2(pi(wd), x), F32_TOL,
                 t, tr)
    pk = offt_tpu.plan(shape, "float32", real=True, planar=True, packed=True)
    pki = offt_tpu.plan(shape, "float32", real=True, inverse=True,
                        planar=True, packed=True)
    pr, pim = pk(xd)
    ur, ui = offt_tpu.unpack_rfft3d(pr, pim)
    t = _timings(pk._fn, (xd,))[0]
    ok &= report(f"b r2c {n}^3 packed",
                 rel_l2(np.asarray(ur) + 1j * np.asarray(ui), want),
                 F32_TOL, t)
    sr, si = offt_tpu.pack_rfft3d(jnp.real(wd), jnp.imag(wd))
    t = _timings(pki._fn, (sr, si))[0]
    ok &= report(f"b c2r {n}^3 packed", rel_l2(pki(sr, si), x), F32_TOL, t)
    return ok


def golden_error(y, n):
    """Relative L2 error of y against the analytic 3-D DFT of the golden
    separable input f = z + 10 y + 100 x on an n^3 grid (run-fft.c:46-126),
    computed on the device in float64 sums: the spectrum is nonzero only
    on the three lines through the origin."""
    import jax
    import jax.numpy as jnp

    k = np.arange(1, n)
    ramp = np.zeros(n, np.complex128)       # sum_j j w^(jk) over j < n
    ramp[0] = n * (n - 1) / 2
    ramp[1:] = -n / (1 - np.exp(-2j * np.pi * k / n))
    lines = {"x": 100 * ramp * n * n, "y": 10 * ramp * n * n,
             "z": ramp * n * n}
    dc = lines["x"][0] + lines["y"][0] + lines["z"][0]

    @jax.jit
    def off_line_energy(v):
        i = jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
        j = jax.lax.broadcasted_iota(jnp.int32, v.shape, 1)
        m = jax.lax.broadcasted_iota(jnp.int32, v.shape, 2)
        on = ((i == 0) & (j == 0)) | ((i == 0) & (m == 0)) | \
            ((j == 0) & (m == 0))
        e = jnp.real(v * jnp.conj(v)).astype(jnp.float64)
        return jnp.sum(jnp.where(on, 0.0, e))

    err2 = float(off_line_energy(y))
    got = {"x": np.asarray(y[:, 0, 0]), "y": np.asarray(y[0, :, 0]),
           "z": np.asarray(y[0, 0, :])}
    ref2 = abs(dc) ** 2
    err2 += abs(got["x"][0] - dc) ** 2
    for ax in "xyz":
        err2 += float(np.sum(np.abs(got[ax][1:] - lines[ax][1:]) ** 2))
        ref2 += float(np.sum(np.abs(lines[ax][1:]) ** 2))
    return float(np.sqrt(err2 / ref2))


def phase_big(n=1024):
    """c. n^3 c2c forward (8 GiB at 1024^3) on the card, checked against
    the analytic spectrum of the golden input and by round trip."""
    import jax
    import jax.numpy as jnp

    import offt_tpu

    shape = (n, n, n)

    @jax.jit
    def golden():
        it = [jax.lax.broadcasted_iota(jnp.float32, shape, a)
              for a in range(3)]
        return (it[2] + 10 * it[1] + 100 * it[0]).astype(jnp.complex64)

    x = golden()
    pf = offt_tpu.plan(shape, "complex64")
    pi = offt_tpu.plan(shape, "complex64", inverse=True)
    y = pf(x)
    ok = report(f"c c2c {n}^3 fwd golden input", golden_error(y, n),
                F32_TOL, *_timings(pf._fn, (x,), jax.jit(jnp.fft.fftn)))

    @jax.jit
    def rel(a, b):
        d = jnp.real((a - b) * jnp.conj(a - b)).astype(jnp.float64)
        r = jnp.real(b * jnp.conj(b)).astype(jnp.float64)
        return jnp.sqrt(jnp.sum(d) / jnp.sum(r))

    err = float(rel(pi(y), x))
    del y
    ok &= report(f"c c2c {n}^3 round trip", err, F32_TOL)
    return ok


def phase_fp64(n=256):
    """d. n^3 complex128 forward and inverse."""
    import jax
    import jax.numpy as jnp

    import offt_tpu

    shape = (n, n, n)
    x = _rand(np.random.default_rng(2), shape, np.complex128)
    want = REF("fftn", x)
    xd = jax.device_put(x)
    pf = offt_tpu.plan(shape, "complex128")
    pi = offt_tpu.plan(shape, "complex128", inverse=True)
    ok = report(f"d c2c {n}^3 complex128 fwd", rel_l2(pf(xd), want),
                F64_TOL, *_timings(pf._fn, (xd,), jax.jit(jnp.fft.fftn)))
    wd = jax.device_put(want)
    ok &= report(f"d c2c {n}^3 complex128 inv", rel_l2(pi(wd), x), F64_TOL,
                 *_timings(pi._fn, (wd,), jax.jit(jnp.fft.ifftn)))
    return ok


def phase_1d(n=1 << 24):
    """e. a long 1-D c2c through the numpy-style namespace."""
    import jax
    import jax.numpy as jnp

    import offt_tpu

    x = _rand(np.random.default_rng(3), (n,), np.complex64)
    want = REF("fft", x.astype(np.complex128))
    xd = jax.device_put(x)
    fwd = jax.jit(offt_tpu.fft.fft)
    inv = jax.jit(offt_tpu.fft.ifft)
    ok = report(f"e 1-D c2c 2^{n.bit_length() - 1} fwd (offt_tpu.fft.fft)",
                rel_l2(fwd(xd), want), F32_TOL,
                *_timings(fwd, (xd,), jax.jit(jnp.fft.fft)))
    wd = jax.device_put(want.astype(np.complex64))
    ok &= report(f"e 1-D c2c 2^{n.bit_length() - 1} inv (offt_tpu.fft.ifft)",
                 rel_l2(inv(wd), x), F32_TOL,
                 *_timings(inv, (wd,), jax.jit(jnp.fft.ifft)))
    return ok


def phase_grad(n=256):
    """f. jax.grad of a spectral loss L(x) = sum w |F x|^2 through a plan,
    against the analytic gradient 2 N Re(ifftn(w * fftn(x)))."""
    import jax
    import jax.numpy as jnp

    import offt_tpu

    shape = (n, n, n)
    rng = np.random.default_rng(4)
    x = _rand(rng, shape, np.float32)
    w = rng.random(shape, dtype=np.float32)
    p = offt_tpu.plan(shape, "complex64")
    wd = jax.device_put(w)

    @jax.jit
    def grad(v):
        return jax.grad(lambda u: jnp.sum(
            wd * jnp.abs(p(u.astype(jnp.complex64))) ** 2))(v)

    x64 = x.astype(np.float64)
    want = 2 * x.size * np.real(REF("ifftn", w * REF("fftn", x64)))
    xd = jax.device_put(x)
    return report(f"f grad of a spectral loss through a {n}^3 plan",
                  rel_l2(grad(xd), want), F32_TOL, _timings(grad, (xd,))[0])


def phase_tune(n=256, trials=4):
    """g. a short tune(): the plan cache is written, keyed by this card's
    device_kind, and plan() reads the tuned point back."""
    import jax

    import offt_tpu
    from offt_tpu.plan import cache
    from offt_tpu.tune import tune

    shape = (n, n, n)
    kind = jax.devices()[0].device_kind
    old = os.environ.get("OFFT_TPU_CACHE_DIR")
    with tempfile.TemporaryDirectory() as d:
        os.environ["OFFT_TPU_CACHE_DIR"] = d
        try:
            res = tune(shape, "complex64", max_trials=trials)
            key = cache.plan_key(shape, "complex64", False, 1, 1, kind)
            stored = cache.lookup(key)
            back = offt_tpu.plan(shape, "complex64").params
        finally:
            if old is None:
                os.environ.pop("OFFT_TPU_CACHE_DIR", None)
            else:
                os.environ["OFFT_TPU_CACHE_DIR"] = old
    ok = (stored == res.best_params and back == res.best_params
          and np.isfinite(res.best_perf))
    print(f"g tune {n}^3 {trials} trials: best={res.best_params} "
          f"best={res.best_perf * 1e3:.4f} ms "
          f"default={res.default_perf * 1e3:.4f} ms cache key {key!r} "
          f"{'read back' if ok else 'NOT read back'}"
          + ("  OK" if ok else "  FAIL"), flush=True)
    return ok


def phase_bench(n=256):
    """h. one offt-bench run, in this process (a second process could not
    get the card's memory), with its own check against numpy."""
    from offt_tpu.bench.runfft import main as bench_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = bench_main(["-N", str(n), "-a", "offt", "-r", "10",
                             "--verify"])
        except SystemExit as e:     # --verify exits on a failed check
            rc = e.code
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    ok = rc == 0 and rec.get("t_ms", 0) > 0
    print(f"h offt-bench: {json.dumps(rec)}" + ("  OK" if ok else "  FAIL"),
          flush=True)
    return ok


# ---- four-card phases -----------------------------------------------------

def _on_distinct_devices(y, count: int) -> bool:
    leaves = y if isinstance(y, tuple) else (y,)
    return all(len({s.device for s in leaf.addressable_shards}) == count
               for leaf in leaves)


def _check_dist(name, y, ref_one, ref_np, count, tol=F32_TOL):
    placed = _on_distinct_devices(y, count)
    if not placed:
        print(f"{name}: output shards are not on {count} distinct devices"
              "  FAIL", flush=True)
    got = np.asarray(y)
    ok = report(f"{name} vs one card", rel_l2(got, ref_one), tol)
    ok &= report(f"{name} vs numpy", rel_l2(got, ref_np), tol)
    return ok and placed


def multi_pencil(n=512, count=4):
    """512^3 c2c on a 2x2 pencil mesh and a 1x4 slab; r2c/c2r on 2x2; the
    ppermute ring (s1=s2=1) and all_gather (v=3) exchanges."""
    import jax

    import offt_tpu
    from offt_tpu.dist import make_mesh

    shape = (n, n, n)
    x = _rand(np.random.default_rng(5), shape, np.complex64)
    want = REF("fftn", x.astype(np.complex128))
    one_f = np.asarray(offt_tpu.plan(shape, "complex64")(x))
    one_i = np.asarray(offt_tpu.plan(shape, "complex64", inverse=True)(one_f))
    ok = True
    q = int(np.sqrt(count))
    for p1, p2 in ((q, count // q), (1, count)):
        mesh = make_mesh(p1, p2)
        pf = offt_tpu.plan(shape, "complex64", mesh=mesh)
        pi = offt_tpu.plan(shape, "complex64", mesh=mesh, inverse=True)
        xd = jax.device_put(x, pf.input_sharding)
        y = pf(xd)
        ok &= _check_dist(f"multi c2c {n}^3 fwd {p1}x{p2}", y, one_f, want,
                          count)
        t = _timings(pf._fn, (xd,))[0]
        print(f"multi c2c {n}^3 fwd {p1}x{p2}: t={t.median * 1e3:.4f} ms "
              f"spread={t.spread:.3f}", flush=True)
        ok &= _check_dist(f"multi c2c {n}^3 inv {p1}x{p2}", pi(y), one_i, x,
                          count)
    mesh = make_mesh(q, count // q)
    base = offt_tpu.plan(shape, "complex64", mesh=mesh).params
    xd = jax.device_put(x, offt_tpu.plan(shape, "complex64",
                                         mesh=mesh).input_sharding)
    for label, pp in (("ppermute ring s1=s2=1", base.replace(s1=1, s2=1)),
                      ("all_gather v=3", base.replace(v=3))):
        y = offt_tpu.plan(shape, "complex64", mesh=mesh, params=pp)(xd)
        ok &= _check_dist(f"multi c2c {n}^3 {label}", y, one_f, want, count)
    xr = x.real.copy()
    rwant = REF("rfftn", xr.astype(np.float64))
    prf = offt_tpu.plan(shape, "float32", real=True, mesh=mesh)
    pri = offt_tpu.plan(shape, "complex64", real=True, inverse=True,
                        mesh=mesh)
    one_r = np.asarray(offt_tpu.plan(shape, "float32", real=True)(xr))
    yr = prf(jax.device_put(xr, prf.input_sharding))
    ok &= _check_dist(f"multi r2c {n}^3 {q}x{count // q}", yr, one_r, rwant,
                      count)
    one_back = np.asarray(offt_tpu.plan(shape, "complex64", real=True,
                                        inverse=True)(one_r))
    ok &= _check_dist(f"multi c2r {n}^3 {q}x{count // q}", pri(yr),
                      one_back, xr, count)
    return ok


def multi_long1d(n=1 << 24, count=4):
    """2^24 distributed long-1-D c2c and the packed real 1-D engine."""
    import jax

    import offt_tpu
    from offt_tpu.dist import make_mesh

    mesh = make_mesh(1, count)
    x = _rand(np.random.default_rng(6), (1, 1, n), np.complex64)
    want = REF("fft", x.astype(np.complex128))
    p = offt_tpu.plan((1, 1, n), "complex64", mesh=mesh)
    if p._shards is None:
        print("multi 1-D c2c: the distributed engine did not engage  FAIL")
        return False
    one = np.asarray(offt_tpu.plan((1, 1, n), "complex64")(x))
    xd = jax.device_put(x, p.input_sharding)
    ok = _check_dist(f"multi 1-D c2c 2^{n.bit_length() - 1}", p(xd), one,
                     want, count)
    xr = _rand(np.random.default_rng(7), (1, 1, n), np.float32)
    m = n // 2
    rw = REF("rfft", xr.astype(np.float64))
    # packed: bin 0 carries DC + i * Nyquist
    packed_want = np.concatenate([rw[..., :1] + 1j * rw[..., m:],
                                  rw[..., 1:m]], axis=-1)
    pr = offt_tpu.plan((1, 1, n), "float32", mesh=mesh, real=True,
                       planar=True, packed=True)
    pri = offt_tpu.plan((1, 1, n), "float32", mesh=mesh, real=True,
                        inverse=True, planar=True, packed=True)
    one = offt_tpu.plan((1, 1, n), "float32", real=True, planar=True,
                        packed=True)(xr)
    one = np.asarray(one[0]) + 1j * np.asarray(one[1])
    hr, hi = pr(jax.device_put(xr, pr.input_sharding))
    placed = _on_distinct_devices((hr, hi), count)
    got = np.asarray(hr) + 1j * np.asarray(hi)
    ok &= placed and report(f"multi packed real 1-D 2^{n.bit_length() - 1} "
                            "vs one card", rel_l2(got, one), F32_TOL)
    ok &= report(f"multi packed real 1-D 2^{n.bit_length() - 1} vs numpy",
                 rel_l2(got, packed_want), F32_TOL)
    back = pri(hr, hi)
    ok &= _on_distinct_devices(back, count) and report(
        f"multi packed c2r 1-D 2^{n.bit_length() - 1} round trip",
        rel_l2(back, xr), F32_TOL)
    return ok


def multi_batch(n=256, count=4):
    """batch_sharded: count x n^3, one whole transform per card."""
    import jax

    import offt_tpu
    from offt_tpu.dist import make_mesh

    mesh = make_mesh(1, count)
    shape = (n, n, n)
    x = _rand(np.random.default_rng(8), (count,) + shape, np.complex64)
    p = offt_tpu.plan(shape, "complex64", mesh=mesh, batch_dims=1,
                      batch_sharded=True)
    one = np.asarray(offt_tpu.plan(shape, "complex64", batch_dims=1)(x))
    want = REF("fftn", x.astype(np.complex128), axes=(-3, -2, -1))
    y = p(jax.device_put(x, p.input_sharding))
    return _check_dist(f"multi batch_sharded {count}x{n}^3", y, one, want,
                       count)


SINGLE = {"a": phase_c2c, "b": phase_real, "c": phase_big, "d": phase_fp64,
          "e": phase_1d, "f": phase_grad, "g": phase_tune, "h": phase_bench}
MULTI = {"pencil": multi_pencil, "long1d": multi_long1d,
         "batch": multi_batch}


def phases(multi: bool) -> dict:
    """The phases one run executes: the four-card ones with --multi, the
    one-card ones otherwise."""
    return MULTI if multi else SINGLE


def card_lines() -> list[str]:
    """nvidia-smi's name and power limit of every card (raises if it
    cannot be read)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phases")
    ns = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py: needs a GPU, JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    count = 4 if ns.multi else 1
    if len(jax.devices()) < count:
        print(f"chip_smoke.py: --multi needs {count} GPUs, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)   # the complex128 phase

    from offt_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    try:
        cards = card_lines()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke.py: nvidia-smi failed: {e}", file=sys.stderr)
        return 1
    print(f"# devices: {jax.devices()}")
    print(f"# cards: {cards}")
    print(f"# XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"compile cache: {cache_dir}", flush=True)

    failed = []
    for name, fn in phases(ns.multi).items():
        try:
            ok = fn(count=count) if ns.multi else fn()
        except Exception:  # report every phase, then fail at the end
            traceback.print_exc()
            print(f"{name}: raised  FAIL", flush=True)
            ok = False
        if not ok:
            failed.append(name)
    for line in cards:
        print(f"card: {line}")
    if failed:
        print(f"chip_smoke.py: failed phases {failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
