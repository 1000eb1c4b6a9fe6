"""Block-shape autotune table: persisted kernel tile winners per
(backend, bucket), the port of ``repro.serving.autotune``.

The reference's ``benchmarks/roofline.py --autotune`` sweeps its Pallas
serve kernel's request-tile size (``bm``) over every serving bucket and
persists the winners as JSON; this module reads and writes the same table
in the same schema::

    {"schema": 1,
     "roofline_bytes_per_s": 1.2e10,
     "entries": {"cuda/4096": {"bm": 256, "us_per_call": 812.4,
                               "bytes_per_s": 9.1e9, "frac": 0.76}, ...}}

Entries are keyed ``"<backend>/<bucket>"``; the port's backends are torch
device types (``"cuda"``, ``"cpu"``), the reference's JAX platforms
(``"cpu"``, ``"gpu"``, ``"tpu"``), so one file can hold both.
:func:`best_bm` is the lookup: the exact bucket, else the nearest recorded
bucket above it, else :data:`DEFAULT_BM`.  No table, an unreadable table
or a missing entry all fall back to the default -- the autotuner is an
optimization, never a dependency.  Nothing in the port reads it yet: its
commit kernel (a warp per segment) has no tile size to tune.

The table location is ``REPRO_AUTOTUNE_PATH`` when set, else
``BENCH_autotune.json`` in the working directory.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

#: the reference's hand-picked default request-tile size
DEFAULT_BM = 256

DEFAULT_PATH = "BENCH_autotune.json"
ENV_PATH = "REPRO_AUTOTUNE_PATH"

AUTOTUNE_SCHEMA = 1

_cache: Dict[str, Optional[dict]] = {}


def table_path() -> str:
    """The autotune table's location (env override, else cwd default)."""
    return os.environ.get(ENV_PATH, DEFAULT_PATH)


def load_table(path: Optional[str] = None) -> Optional[dict]:
    """Load (and memoize) the autotune table; None when absent/corrupt."""
    path = path or table_path()
    if path in _cache:
        return _cache[path]
    table = None
    try:
        with open(path) as f:
            loaded = json.load(f)
        if isinstance(loaded, dict) and loaded.get("schema") == AUTOTUNE_SCHEMA:
            table = loaded
    except (OSError, ValueError):
        table = None
    _cache[path] = table
    return table


def clear_cache() -> None:
    """Drop the memoized table (tests; after re-running the autotuner)."""
    _cache.clear()


def save_table(table: dict, path: Optional[str] = None) -> str:
    """Persist an autotune table (and invalidate the memo)."""
    path = path or table_path()
    table = dict(table, schema=AUTOTUNE_SCHEMA)
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    clear_cache()
    return path


def best_bm(backend: str, bucket: int, path: Optional[str] = None) -> int:
    """The tuned request-tile size for ``(backend, bucket)``.

    Falls back to the nearest recorded bucket >= the asked one (the
    kernel clamps ``bm`` to the batch, so a larger bucket's winner is
    valid for smaller batches), then to :data:`DEFAULT_BM`.
    """
    table = load_table(path)
    if table is None:
        return DEFAULT_BM
    entries = table.get("entries", {})
    exact = entries.get(f"{backend}/{int(bucket)}")
    if exact is not None:
        return int(exact["bm"])
    candidates = []
    prefix = f"{backend}/"
    for key, entry in entries.items():
        if key.startswith(prefix):
            try:
                candidates.append((int(key[len(prefix):]), int(entry["bm"])))
            except (ValueError, KeyError, TypeError):
                continue
    larger = sorted(c for c in candidates if c[0] >= int(bucket))
    if larger:
        return larger[0][1]
    return DEFAULT_BM


__all__ = [
    "AUTOTUNE_SCHEMA",
    "DEFAULT_BM",
    "DEFAULT_PATH",
    "ENV_PATH",
    "best_bm",
    "clear_cache",
    "load_table",
    "save_table",
    "table_path",
]
