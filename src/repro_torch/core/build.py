"""Constructors wiring TrainStats into the cache configurations of the paper.

A copy of ``repro.core.build``, a thin wrapper: every strategy name maps
to a declarative spec (:func:`repro_torch.core.spec.CacheSpec.from_strategy`)
which is compiled to the exact per-request engine.  The vectorized twin
(:func:`repro_torch.core.fast.make_layout`) and the device cache
(``CacheSpec.to_device``) compile the *same* spec, so the three engines
evaluate the same cache.

Configurations (paper Sec. 3.2 / Sec. 5):

* ``SDC``            -- baseline: static top-|S| + LRU.
* ``STDf_LRU``       -- topic sections LRU, uniform sizes.
* ``STDv_LRU``       -- topic sections LRU, sizes proportional to popularity.
* ``STDv_SDC_C1``    -- topic sections SDC; global S holds top *no-topic*
                        queries only.
* ``STDv_SDC_C2``    -- topic sections SDC; global S holds top queries
                        overall; popular topical queries not already in S go
                        to their section's static fraction.
* ``Tv_SDC``         -- no global S/D; no-topic queries form topic k+1; all
                        sections SDC sized proportionally.
"""
from __future__ import annotations

from typing import Optional

from .policies import CacheUnit, LRUCache, SDCCache
from .spec import STRATEGIES, CacheSpec, split_sizes
from .stats import TrainStats

__all__ = [
    "STRATEGIES",
    "build_lru",
    "build_sdc",
    "build_std",
    "split_sizes",
]


def build_sdc(n: int, f_s: float, stats: TrainStats) -> SDCCache:
    n_static = int(round(f_s * n))
    return SDCCache(stats.by_freq[:n_static], n - n_static)


def build_lru(n: int) -> LRUCache:
    return LRUCache(n)


def build_std(
    strategy: str,
    n: int,
    stats: TrainStats,
    f_s: float = 0.0,
    f_t: float = 0.0,
    f_ts: Optional[float] = None,
) -> CacheUnit:
    """Build any strategy from the paper's experimental grid.

    ``f_d`` is implied (= 1 - f_s - f_t), matching the paper's tuning: "the
    other parameters are tuned based on the remaining size of the cache".
    """
    if strategy == "Tv_SDC" and f_ts is None:
        f_ts = 0.5  # historical default of this entry point
    spec = CacheSpec.from_strategy(strategy, n, f_s=f_s, f_t=f_t, f_ts=f_ts)
    return spec.to_exact(stats)
