"""Layered configuration: defaults < config file < environment < kwargs.

Re-expression of Active Harmony's key=value config system (hcfg.c: global
harmony.cfg merged under per-session config, hserver.c:668; env overrides
HARMONY_S_HOST/PORT/CONFIG, hclient.h:63-66; all keys in defaults.h:32-70).
Keys are case-insensitive strings; the file is JSON at
$OFFT_TPU_CONFIG (default ~/.config/offt_tpu/config.json); any key can be
overridden by an OFFT_TPU_<KEY> environment variable.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any

DEFAULTS: dict[str, Any] = {
    # tuning (defaults.h analogues)
    "strategy": "nm",
    "max_trials": 30,
    "simplex_size": 0,            # 0 = ndims + 1
    "prefetch_count": 4,          # Tuner batch (PREFETCH_COUNT analogue)
    "server_host": "127.0.0.1",
    "server_port": 1979,
    # paths
    "cache_dir": "",              # "" = ~/.cache/offt_tpu
}


def _config_path() -> pathlib.Path:
    p = os.environ.get("OFFT_TPU_CONFIG")
    if p:
        return pathlib.Path(p)
    return pathlib.Path(os.path.expanduser("~/.config/offt_tpu/config.json"))


def _load_file() -> dict:
    f = _config_path()
    if not f.exists():
        return {}
    try:
        data = json.loads(f.read_text())
        return {str(k).lower(): v for k, v in data.items()}
    except (json.JSONDecodeError, OSError):
        return {}


def get(key: str, default: Any = None, **overrides) -> Any:
    """Resolve a config key through all layers (case-insensitive)."""
    key = key.lower()
    if key in overrides and overrides[key] is not None:
        return overrides[key]
    env = os.environ.get(f"OFFT_TPU_{key.upper()}")
    if env is not None:
        base = DEFAULTS.get(key, default)
        if isinstance(base, bool):
            return env.lower() in ("1", "true", "yes", "on")
        if isinstance(base, int):
            try:
                return int(env)
            except ValueError:
                pass
        return env
    fromfile = _load_file().get(key)
    if fromfile is not None:
        return fromfile
    return DEFAULTS.get(key, default)


def snapshot(**overrides) -> dict[str, Any]:
    """All keys resolved through the layers (for logging/reproducibility)."""
    out = {}
    for k in DEFAULTS:
        out[k] = get(k, **overrides)
    return out
