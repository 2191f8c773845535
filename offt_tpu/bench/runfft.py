"""Benchmark driver CLI — the re-expression of the reference's run-fft.c.

The reference driver (run-fft.c:128-515) takes -N/-n/-L sizes, -a algorithm
{0=OFFT, 1=FFTW-MPI, 2=P3DFFT, 3=2DECOMP}, -R r2c, -r reps, tuning flags
(-s strategy, -l max_loop) and per-parameter overrides, fills a
deterministic input, times init/reps/fin, and prints per-stage breakdowns.

Here: ``python -m offt_tpu.bench.runfft -N 256 -a offt --tune ...``
Algorithms: offt (this library), xla (jnp.fft on device), numpy (host).
Output: human-readable lines + one machine-readable JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from ..obs.profile import Timing, time_fn


def _parse_args(argv=None):
    p = argparse.ArgumentParser(prog="offt-bench",
                                description="offt-tpu benchmark driver")
    p.add_argument("-N", type=int, default=256, help="cube size (Nx=Ny=Nz)")
    p.add_argument("--nx", type=int, default=0)
    p.add_argument("--ny", type=int, default=0)
    p.add_argument("--nz", type=int, default=0)
    p.add_argument("-a", "--algo", default="offt",
                   choices=["offt", "xla", "numpy", "jaxdecomp"])
    p.add_argument("-R", "--r2c", action="store_true")
    p.add_argument("--packed", action="store_true",
                   help="r2c/c2r in the packed half-spectrum layout "
                        "(kernels/rfft.py)")
    p.add_argument("-b", "--batch", type=int, default=0,
                   help="leading batch dim (BASELINE config 5 style)")
    p.add_argument("-i", "--inverse", action="store_true")
    p.add_argument("-r", "--reps", type=int, default=5)
    p.add_argument("--p1", type=int, default=0, help="mesh rows (0=auto)")
    p.add_argument("--p2", type=int, default=0, help="mesh cols (0=auto)")
    p.add_argument("--mesh", action="store_true",
                   help="distribute over all visible devices")
    p.add_argument("--tune", action="store_true")
    p.add_argument("-s", "--strategy", default="nm",
                   help="tuning strategy: nm|pro|random|brute")
    p.add_argument("-l", "--max-trials", type=int, default=30)
    p.add_argument("-A", "--fast-trial", type=int, default=0,
                   help="FAST_TUNING extrapolation window: time only the "
                        "first K pipeline chunks per phase during search "
                        "(run-fft.c -A parity); finalists re-measured "
                        "exactly")
    p.add_argument("--log", default="", help="JSONL trial/event log path")
    # per-parameter overrides (reference run-fft.c:207-230 one flag per knob)
    for knob in ("t1", "t2", "w1", "w2", "ry", "s1", "s2", "v"):
        p.add_argument(f"--{knob}", type=int, default=None)
    p.add_argument("--engine", default=None, choices=["xla", "matmul"],
                   help="local transform engine")
    p.add_argument("--radix-z", default=None, help="e.g. 16,16")
    p.add_argument("--radix-y", default=None)
    p.add_argument("--radix-x", default=None)
    p.add_argument("--split-1d", default=None,
                   help="(n1,n2) matrix view of the distributed long-1-D "
                        "engine, e.g. 1024,1024 (dist/long1d.py)")
    p.add_argument("--verify", action="store_true",
                   help="check output vs numpy (golden input)")
    p.add_argument("--breakdown", action="store_true",
                   help="per-stage timing table (offt_print_time parity)")
    return p.parse_args(argv)


def main(argv=None):
    ns = _parse_args(argv)
    nx = ns.nx or ns.N
    ny = ns.ny or ns.N
    nz = ns.nz or ns.N
    shape = (nx, ny, nz)
    if ns.batch:
        shape = (ns.batch,) + shape
    total = nx * ny * nz
    flops = 5.0 * total * math.log2(total) * max(ns.batch, 1)

    rng = np.random.default_rng(0)
    t_init0 = time.time()

    if ns.algo == "numpy":
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        fn = (np.fft.rfftn if ns.r2c else np.fft.fftn)
        arg = x.real.copy() if ns.r2c else x
        fn(arg)
        t = Timing(tuple(_time_host(fn, arg) for _ in range(ns.reps)))
        _summary(ns, shape, flops, t, t_init=time.time() - t_init0)
        return 0

    import jax

    import offt_tpu
    from offt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if ns.algo == "jaxdecomp":
        # third-party distributed-FFT baseline (run-fft.c:312-353 compares
        # FFTW-MPI/P3DFFT/2DECOMP in-process; SURVEY §6 names jaxdecomp
        # as the JAX-side analogue). Import-gated BEFORE any device work:
        # the package is optional and off the main path; the branch runs
        # wherever jaxdecomp is installed.
        try:
            import jaxdecomp  # noqa: F401
        except ImportError:
            print("# jaxdecomp is not installed in this environment; "
                  "install it to enable this baseline", file=sys.stderr)
            print(json.dumps({"algo": "jaxdecomp", "shape": list(shape),
                              "error": "jaxdecomp not installed"}))
            return 2
        if ns.r2c or ns.inverse:
            # reject unsupported modes BEFORE tuning/device work, and keep
            # the one-JSON-line CLI contract even on the error path
            print("# jaxdecomp baseline wired for c2c forward only",
                  file=sys.stderr)
            print(json.dumps({"algo": "jaxdecomp", "shape": list(shape),
                              "error": "c2c forward only"}))
            return 2

    mesh = None
    if ns.mesh or ns.p1 or ns.p2:
        from offt_tpu.dist import make_mesh
        devs = jax.devices()
        p1 = ns.p1 or 1
        p2 = ns.p2 or (len(devs) // p1)
        mesh = make_mesh(p1, p2)

    overrides = {k: getattr(ns, k) for k in
                 ("t1", "t2", "w1", "w2", "ry", "s1", "s2", "v", "engine")
                 if getattr(ns, k) is not None}
    for flag, key in (("radix_z", "radix_z"), ("radix_y", "radix_y"),
                      ("radix_x", "radix_x"), ("split_1d", "split_1d")):
        v = getattr(ns, flag)
        if v:
            overrides[key] = tuple(int(t) for t in v.split(","))

    params = None
    if ns.tune:
        from offt_tpu.tune import tune
        res = tune(shape[-3:], "complex64", mesh=mesh, real=ns.r2c,
                   strategy=ns.strategy, max_trials=ns.max_trials,
                   log_path=ns.log or None, inverse=ns.inverse,
                   fast_trial=ns.fast_trial)
        params = res.best_params
        print(f"# tuned: best={params} perf={res.best_perf * 1e3:.3f} ms "
              f"default={res.default_perf * 1e3:.3f} ms "
              f"speedup={res.speedup_vs_default:.2f}x", file=sys.stderr)
    if overrides:
        base = params or offt_tpu.plan(shape[-3:], "complex64", mesh=mesh,
                                       real=ns.r2c,
                                       batch_dims=len(shape) - 3).params
        params = base.replace(**overrides)

    in_shape = shape
    if ns.r2c and ns.inverse:   # c2r input: half spectrum
        m = shape[-1] // 2
        in_shape = shape[:-1] + ((m,) if ns.packed else (m + 1,))
    re = jax.device_put(rng.standard_normal(in_shape).astype(np.float32))
    if ns.algo == "offt":
        p = offt_tpu.plan(shape[-3:], "complex64", mesh=mesh, real=ns.r2c,
                          inverse=ns.inverse, params=params, planar=True,
                          batch_dims=len(shape) - 3,
                          packed=ns.packed and ns.r2c)
        if ns.r2c and not ns.inverse:
            args = (re,)
        else:
            im = jax.device_put(
                rng.standard_normal(in_shape).astype(np.float32))
            args = (re, im)
        fn = p._fn
        t_init = time.time() - t_init0
        t = time_fn(fn, args, reps=ns.reps)
        if ns.verify:
            _verify(p, shape, ns)
        if ns.breakdown and not ns.r2c and not ns.batch:
            if mesh is None:
                from offt_tpu.obs.profile import fft3d_breakdown
                bd = fft3d_breakdown(shape, params=params)
            else:
                # per-phase split on the mesh (offt.h:171-188 parity)
                from offt_tpu.obs.profile import pencil_breakdown
                bd = pencil_breakdown(shape, mesh, params=params)
            for k, v in bd.items():
                print(f"# {k}: {v * 1e3:.3f} ms", file=sys.stderr)
    elif ns.algo == "jaxdecomp":
        import jax.numpy as jnp
        import jaxdecomp
        im = jax.device_put(rng.standard_normal(shape).astype(np.float32))

        @jax.jit
        def fn(r, i):
            y = jaxdecomp.fft.pfft3d(jax.lax.complex(r, i))
            return jnp.real(y), jnp.imag(y)
        args = (re, im)
        t_init = time.time() - t_init0
        t = time_fn(fn, args, reps=ns.reps)
    else:  # xla
        import jax.numpy as jnp

        if ns.packed:
            # the packed layout is offt's own; XLA has no analogue
            print(json.dumps({"algo": "xla", "shape": list(shape),
                              "error": "packed layout has no XLA analogue"}))
            return 2
        if ns.r2c and ns.inverse:
            # c2r: irfftn from the numpy-layout half spectrum (in_shape
            # already carries M+1 trailing lanes)
            xla_fn = "irfftn"
            im = jax.device_put(
                rng.standard_normal(in_shape).astype(np.float32))

            def fn(r, i):
                return (jnp.fft.irfftn(jax.lax.complex(r, i),
                                       s=shape[-3:]),)
            args = (re, im)
        elif ns.r2c:
            xla_fn = "rfftn"

            def fn(r):
                y = jnp.fft.rfftn(r)
                return jnp.real(y), jnp.imag(y)
            args = (re,)
        else:
            xla_fn = "ifftn" if ns.inverse else "fftn"
            im = jax.device_put(rng.standard_normal(shape).astype(np.float32))

            if ns.inverse:
                def fn(r, i):
                    y = jnp.fft.ifftn(jax.lax.complex(r, i))
                    return jnp.real(y), jnp.imag(y)
            else:
                def fn(r, i):
                    y = jnp.fft.fftn(jax.lax.complex(r, i))
                    return jnp.real(y), jnp.imag(y)
            args = (re, im)
        jit_kw = {}
        if mesh is not None and len(shape) == 3:
            # distributed cross-check: feed XLA the SAME pencil-sharded
            # inputs the offt plan takes and let GSPMD insert its own
            # collectives — an independent distributed FFT running
            # in-driver, the analogue of the reference's P3DFFT/2DECOMP
            # comparisons (run-fft.c:312-353; the jaxdecomp branch stays
            # gated for environments that have it)
            from offt_tpu.dist.mesh import input_sharding, output_sharding
            if shape[:2] == (1, 1):
                # degenerate 1-D: the natural flat layout the dist-1d
                # engine uses (pencil specs would shard size-1 axes)
                from offt_tpu.dist.long1d import natural_sharding
                ish = natural_sharding(mesh, 3)
            else:
                ish = (output_sharding(mesh, 3) if ns.inverse
                       else input_sharding(mesh, 3))
            jit_kw["in_shardings"] = tuple(ish for _ in args)
            xla_fn += "@mesh"
        fn = jax.jit(fn, **jit_kw)
        t_init = time.time() - t_init0
        try:
            t = time_fn(fn, args, reps=ns.reps)
        except Exception as e:  # pragma: no cover - backend-dependent
            # e.g. GSPMD's FFT partitioner rewrites a SHARDED-axis 1-D
            # transform via a dense DFT contraction — O(n * n/P) scratch,
            # 137 GB at N=2^20 on the CPU mesh (probed). That the
            # baseline cannot run the sharded problem is itself a
            # comparison result; keep the one-JSON-line contract.
            print(f"# xla baseline failed: {e}", file=sys.stderr)
            print(json.dumps({"algo": "xla", "shape": list(shape),
                              "xla_fn": xla_fn, "error": str(e)[:200]}))
            return 2
        _summary(ns, shape, flops, t, t_init=t_init, xla_fn=xla_fn)
        return 0

    _summary(ns, shape, flops, t, t_init=t_init)
    return 0


def _time_host(fn, arg):
    t0 = time.perf_counter()
    fn(arg)
    return time.perf_counter() - t0


def _verify(p, shape, ns):
    rng = np.random.default_rng(1)
    if ns.r2c and not ns.inverse:
        x = rng.standard_normal(shape).astype(np.float32)
        got = p(x)
        if ns.packed:   # unpack outside the timed region
            from offt_tpu.kernels.rfft import unpack_rfft3d
            got = unpack_rfft3d(*got)
        got = np.asarray(got[0]) + 1j * np.asarray(got[1])
        want = np.fft.rfftn(x, axes=(-3, -2, -1))
    elif ns.r2c:        # c2r: plan takes a Hermitian half-spectrum,
        # returns a real cube — roundtrip from a real cube so the
        # spectrum is valid (a random full-shape array is NOT, which is
        # what this branch fed the plan before: rel_err 1.2 artifacts)
        x = rng.standard_normal(shape).astype(np.float32)
        spec = np.fft.rfftn(x, axes=(-3, -2, -1)).astype(np.complex64)
        sr = np.ascontiguousarray(spec.real)
        si = np.ascontiguousarray(spec.imag)
        if ns.packed:
            from offt_tpu.kernels.rfft import pack_rfft3d
            sr, si = (np.asarray(v) for v in pack_rfft3d(sr, si))
        got = np.asarray(p((sr, si)))
        want = np.fft.irfftn(spec, s=shape[-3:], axes=(-3, -2, -1))
    else:
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        out = p((x.real.copy(), x.imag.copy()))
        got = np.asarray(out[0]) + 1j * np.asarray(out[1])
        axes = (-3, -2, -1)
        want = (np.fft.ifftn(x, axes=axes) if ns.inverse
                else np.fft.fftn(x, axes=axes))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"# verify rel_err = {err:.3e}", file=sys.stderr)
    if err > 1e-5:
        print("# VERIFY FAILED", file=sys.stderr)
        sys.exit(1)


def _summary(ns, shape, flops, t, t_init, **extra):
    """One JSON line: median time and its spread, 5 N log2 N GFLOP/s,
    and the device it ran on."""
    gflops = flops / t.median / 1e9
    device = {"platform": "cpu", "kind": "host numpy", "count": 1}
    if ns.algo != "numpy":
        import jax
        d = jax.devices()
        device = {"platform": d[0].platform, "kind": d[0].device_kind,
                  "count": len(d)}
    rec = {
        "algo": ns.algo, "shape": list(shape),
        "kind": "r2c" if ns.r2c else "c2c",
        "t_ms": t.median * 1e3, "spread": t.spread, "reps": len(t.times),
        "gflops": gflops, "t_init_s": t_init, "device": device, **extra,
    }
    print(f"# {ns.algo} {shape} {'r2c' if ns.r2c else 'c2c'} "
          f"t_median={t.median * 1e3:.3f} ms t_init={t_init:.2f} s "
          f"{gflops:.1f} GFLOP/s on {device['kind']}", file=sys.stderr)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
