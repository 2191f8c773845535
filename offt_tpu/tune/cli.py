"""offt-tune: generic black-box command-line tuner — the re-expression of
Active Harmony's ``tuna`` (/root/reference/activeharmony/build/tuna.c).

Like tuna, you declare tunable variables (-i int ranges, -e enums), give a
command template with %name substitutions, and pick a measurement method:
wall time (-m wall, default) or the first number on stdout (-m stdout).
The search runs one of our strategies (nm/pro/random/brute, Python or the
native C++ engine with --native).

Example (tuna.c's canonical synth example):

    python -m offt_tpu.tune.cli -i x:1:100 -i y:1:100 -m stdout \
        -s nm -l 100 -- ./synth %x %y

Also usable to tune a jitted function exposed by a Python module via
--pyfn module:function (called with the point as kwargs, returns seconds).

One process per card: in command mode each trial runs in a child, one at
a time, and this parent never touches a device (importing jax is
harmless; using a device reserves most of the card's memory, which the
child then could not get).
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time

from ..obs.log import EventLog
from ..plan.params import ProblemSpec
from .space import Dimension
from .synth import _SynthSpace
from .tuner import Tuner

INF = float("inf")


def _parse_var(spec: str, kind: str) -> Dimension:
    name, *rest = spec.split(":")
    if kind == "int":
        if len(rest) == 2:
            lo, hi = int(rest[0]), int(rest[1])
            step = 1
        elif len(rest) == 3:
            lo, hi, step = int(rest[0]), int(rest[1]), int(rest[2])
        else:
            raise ValueError(f"bad -i spec {spec!r}; want name:lo:hi[:step]")
        return Dimension(name, tuple(range(lo, hi + 1, step)))
    if kind == "real":
        lo, hi, step = float(rest[0]), float(rest[1]), float(rest[2])
        vals, v = [], lo
        while v <= hi + 1e-12:
            vals.append(round(v, 12))
            v += step
        return Dimension(name, tuple(vals))
    # enum
    return Dimension(name, tuple(rest))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="offt-tune",
        description="generic black-box tuner (tuna parity). In command "
                    "mode trials run one at a time in child processes and "
                    "this process never touches a GPU, so each child can "
                    "take the whole card.")
    p.add_argument("-i", action="append", default=[], metavar="name:lo:hi[:step]",
                   help="integer variable")
    p.add_argument("-f", action="append", default=[], metavar="name:lo:hi:step",
                   help="real variable")
    p.add_argument("-e", action="append", default=[], metavar="name:v1:v2:...",
                   help="enum variable")
    p.add_argument("-m", "--method", default="wall",
                   choices=["wall", "user", "sys", "stdout"],
                   help="objective: wall | user | sys CPU time of the child "
                        "(tuna.c:43-50 parity) | first float on stdout")
    p.add_argument("-s", "--strategy", default="nm",
                   choices=["nm", "pro", "random", "brute"])
    p.add_argument("-l", "--max-trials", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--native", action="store_true",
                   help="use the C++ engine instead of Python strategies")
    p.add_argument("--server", default="",
                   help="host:port of a running tuning service (the "
                        "hserver-parity mode; tuna.c auto-spawn analogue)")
    p.add_argument("--log", default="", help="JSONL trial log path")
    p.add_argument("--pyfn", default="",
                   help="module:function objective instead of a command")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- command template with %%name substitutions")
    ns = p.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    dims = ([_parse_var(s, "int") for s in ns.i]
            + [_parse_var(s, "real") for s in ns.f]
            + [_parse_var(s, "enum") for s in ns.e])
    if not dims:
        p.error("declare at least one variable (-i/-f/-e)")
    space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)), dims=tuple(dims))
    names = [d.name for d in dims]

    cmd = ns.cmd[1:] if ns.cmd[:1] == ["--"] else ns.cmd
    if not cmd and not ns.pyfn:
        p.error("give a command template after -- or use --pyfn")

    if ns.pyfn:
        mod, fn = ns.pyfn.split(":")
        fobj = getattr(importlib.import_module(mod), fn)

        def objective(vals):
            return float(fobj(**dict(zip(names, vals))))
    else:
        def objective(vals):
            sub = {f"%{n}": str(v) for n, v in zip(names, vals)}
            argv_t = []
            for tok in cmd:
                for k, v in sub.items():
                    tok = tok.replace(k, v)
                argv_t.append(tok)
            # user/sys CPU time of the child (tuna.c measures rusage of the
            # fork/exec'd trial): delta of RUSAGE_CHILDREN around the run
            # is exact because trials execute serially
            if ns.method in ("user", "sys"):
                import resource
                ru0 = resource.getrusage(resource.RUSAGE_CHILDREN)
            t0 = time.perf_counter()
            res = subprocess.run(argv_t, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            if res.returncode != 0:
                return INF
            if ns.method == "stdout":
                for tok in res.stdout.split():
                    try:
                        return float(tok)
                    except ValueError:
                        continue
                return INF
            if ns.method == "user":
                ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
                return max(ru1.ru_utime - ru0.ru_utime, 1e-9)
            if ns.method == "sys":
                ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
                return max(ru1.ru_stime - ru0.ru_stime, 1e-9)
            return wall

    spawned = None
    if ns.server:
        from .client import ServiceClient
        if ns.server == "auto":
            # auto-spawn the native server (tuna.c:164-197 parity)
            from .engine_cpp import spawn_server
            spawned, port_num = spawn_server()
            host, port = "127.0.0.1", str(port_num)
        else:
            host, _, port = ns.server.partition(":")
        strategy = ServiceClient(host or "127.0.0.1", int(port or 1979))
        strategy.create_session([(d.name, list(range(len(d.values))))
                                 for d in dims],
                                strategy=ns.strategy, seed=ns.seed)
    elif ns.native:
        from .engine_cpp import make_native_strategy
        strategy = make_native_strategy(ns.strategy, space, seed=ns.seed)
    else:
        strategy = ns.strategy

    tuner = Tuner(space, objective, strategy=strategy,
                  max_trials=ns.max_trials, seed=ns.seed,
                  log=EventLog(ns.log or None, echo=not ns.quiet))
    best, perf = tuner.run()
    # Tuner.run already maps the winning point to values
    out = {"best": dict(zip(names, best)) if best else None,
           "perf": perf,
           "trials": len(tuner.trials),
           "converged": tuner.strategy.converged()}
    print(json.dumps(out))
    if spawned is not None:
        spawned.kill()  # offt kills its spawned server too (offt-tuning.c:1018)
    return 0 if best is not None else 1


if __name__ == "__main__":
    sys.exit(main())
