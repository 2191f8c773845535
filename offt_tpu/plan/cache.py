"""Persistent best-plan cache.

Upgrade over the reference's within-run point database (tmp-db-<rand>,
offt-tuning.c:231-277, deleted per session): plans tuned once are reusable
across processes, keyed by (shape, dtype, transform kind, mesh shape,
device kind). Stored as a single JSON file under OFFT_TPU_CACHE_DIR
(default: ~/.cache/offt_tpu).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Optional

from .params import PlanParams


def cache_dir() -> pathlib.Path:
    d = os.environ.get("OFFT_TPU_CACHE_DIR")
    if not d:
        from ..utils import config as _cfg
        d = _cfg.get("cache_dir")
    if d:
        return pathlib.Path(d)
    return pathlib.Path(os.path.expanduser("~/.cache/offt_tpu"))


def _cache_file() -> pathlib.Path:
    return cache_dir() / "plan_cache.json"


def plan_key(shape, dtype, real: bool, p1: int, p2: int,
             device_kind: str = "", batch: int = 1,
             inverse: bool = False, batch_sharded: bool = False) -> str:
    """Cache key. Direction and batch-sharded mode are part of the key:
    params tuned for the forward transform must not silently apply to the
    inverse (phase-1 chunks the z extent there, not x) or to the
    zero-collective batch-sharded mode."""
    parts = [
        "x".join(map(str, shape)), str(dtype), "r2c" if real else "c2c",
        f"{p1}x{p2}", device_kind, f"b{batch}",
    ]
    if inverse:
        parts.append("inv")
    if batch_sharded:
        parts.append("bs")
    return "|".join(parts)


def _load() -> dict:
    f = _cache_file()
    if not f.exists():
        return {}
    try:
        return json.loads(f.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def _params_to_json(p: PlanParams) -> dict:
    d = dataclasses.asdict(p)
    for k in ("radix_z", "radix_y", "radix_x", "split_1d"):
        if d[k] is not None:
            d[k] = list(d[k])
    return d


def _params_from_json(d: dict) -> PlanParams:
    d = dict(d)
    for k in ("radix_z", "radix_y", "radix_x", "split_1d"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    # drop unknown keys (older/newer cache rows across versions)
    known = {f.name for f in dataclasses.fields(PlanParams)}
    d = {k: v for k, v in d.items() if k in known}
    return PlanParams(**d)


def lookup(key: str) -> Optional[PlanParams]:
    rec = _load().get(key)
    if rec is None:
        return None
    try:
        return _params_from_json(rec["params"])
    except (KeyError, TypeError):
        return None


def store(key: str, params: PlanParams, perf: float | None = None) -> None:
    db = _load()
    old = db.get(key)
    if old is not None and perf is not None and old.get("perf") is not None:
        if old["perf"] <= perf:
            return  # keep the better plan
    db[key] = {"params": _params_to_json(params), "perf": perf}
    d = cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    # atomic replace so concurrent tuners don't corrupt the cache
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(db, fh, indent=1, sort_keys=True)
        os.replace(tmp, _cache_file())
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def clear() -> None:
    try:
        _cache_file().unlink()
    except FileNotFoundError:
        pass


# ---- wisdom-style portability (fftw_export_wisdom/import parity:
# the reference's FFTW sub-plans keep wisdom process-local; here tuned
# plans can move between machines of the same device kind) ----

def export_wisdom(path) -> int:
    """Write the local cache to ``path``; returns the number of entries."""
    db = _load()
    pathlib.Path(path).write_text(json.dumps(db, indent=1, sort_keys=True))
    return len(db)


def import_wisdom(path) -> int:
    """Merge entries from ``path`` into the local cache; returns the
    number of entries actually applied.

    Better-perf-wins per key, in ONE in-memory merge + one atomic
    write: a measured local entry is never replaced by an incoming
    entry without a better measured perf (perf-less incoming rows only
    fill missing keys)."""
    incoming = json.loads(pathlib.Path(path).read_text())
    db = _load()
    n = 0
    for key, rec in incoming.items():
        try:
            _params_from_json(rec["params"])  # validate
        except (KeyError, TypeError):
            continue
        old = db.get(key)
        if old is not None:
            new_perf = rec.get("perf")
            if new_perf is None or (old.get("perf") is not None
                                    and old["perf"] <= new_perf):
                continue
        db[key] = {"params": rec["params"], "perf": rec.get("perf")}
        n += 1
    if n:
        d = cache_dir()
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as fh:
            json.dump(db, fh, indent=1, sort_keys=True)
        os.replace(tmp, _cache_file())
    return n


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m offt_tpu.plan.cache",
        description="tuned-plan cache (wisdom) maintenance")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="print cache entries")
    pe = sub.add_parser("export", help="write merged cache to FILE")
    pe.add_argument("file")
    pi = sub.add_parser("import", help="merge FILE into the local cache")
    pi.add_argument("file")
    sub.add_parser("clear", help="delete the local cache")
    ns = ap.parse_args(argv)
    if ns.cmd == "list":
        local = _load()
        for k, rec in sorted(local.items()):
            perf = rec.get("perf")
            perf_s = f"{perf * 1e3:.3f} ms" if perf else "-"
            print(f"{k}  perf={perf_s}")
        print(f"# {len(local)} entries ({_cache_file()})")
    elif ns.cmd == "export":
        print(f"exported {export_wisdom(ns.file)} entries -> {ns.file}")
    elif ns.cmd == "import":
        print(f"imported {import_wisdom(ns.file)} entries")
    elif ns.cmd == "clear":
        clear()
        print("cleared", _cache_file())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
