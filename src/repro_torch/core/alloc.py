"""Topic-cache entry allocation (paper Sec. 3.3, "Estimating Topic Popularity").

A copy of ``repro.core.alloc``: ``proportional_allocation`` (the device
cache's topic split), ``allocation_divergence`` (the rebalance trigger) and
``uniform_allocation`` (STDf specs).

Each topic gets ``|T.tau| = round(|T| * q_tau / q)`` entries, where ``q_tau``
is the number of *distinct* training queries in topic ``tau`` and ``q`` the
total number of distinct training queries with a topic.

The paper uses plain nearest-integer rounding, which can over/under-shoot
``|T|`` by up to k/2 entries.  ``exact=True`` switches to largest-remainder
apportionment so the sizes sum to exactly ``|T|`` (a beyond-paper knob used
by the device cache, whose set ranges must tile an address space exactly).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def proportional_allocation(
    total_entries: int,
    topic_distinct_counts: Mapping[int, int],
    exact: bool = False,
) -> Dict[int, int]:
    """Split ``total_entries`` across topics proportionally to popularity."""
    if total_entries < 0:
        raise ValueError("total_entries must be >= 0")
    topics = sorted(topic_distinct_counts)
    counts = np.array([topic_distinct_counts[t] for t in topics], dtype=np.float64)
    q = counts.sum()
    if total_entries == 0 or q <= 0:
        return {t: 0 for t in topics}
    shares = total_entries * counts / q
    if not exact:
        # Paper-faithful: nearest integer ("|x]" in the paper), half-to-even
        # resolved half-up to match the worked example |1.66| = 2, |3.33| = 3.
        sizes = np.floor(shares + 0.5).astype(np.int64)
        return {t: int(s) for t, s in zip(topics, sizes)}
    base = np.floor(shares).astype(np.int64)
    remainder = int(total_entries - base.sum())
    if remainder > 0:
        frac = shares - base
        # Stable tie-break on (fraction desc, popularity desc, topic id asc).
        order = np.lexsort((np.arange(len(topics)), -counts, -frac))
        base[order[:remainder]] += 1
    return {t: int(s) for t, s in zip(topics, base)}


def allocation_divergence(a: Mapping[int, float], b: Mapping[int, float]) -> float:
    """L1 distance between two allocations' normalized shares, in [0, 2].

    Scale-free: ``a`` and ``b`` may be entry counts, request counts, or
    decayed popularity estimates -- only the *shapes* of the distributions
    are compared.  Used by the serving tier's rebalance trigger to decide
    whether tracked live popularity has drifted far enough from the
    current topic allocation to be worth a migration.
    """
    ta = float(sum(a.values()))
    tb = float(sum(b.values()))
    if ta <= 0 or tb <= 0:
        # one side is empty: identical iff both are, else maximally apart
        return 0.0 if ta == tb else 2.0
    keys = set(a) | set(b)
    return float(sum(abs(a.get(k, 0) / ta - b.get(k, 0) / tb) for k in keys))


def uniform_allocation(total_entries: int, topics) -> Dict[int, int]:
    """STDf: every topic gets |T|/k entries (floor; paper divides equally)."""
    topics = sorted(topics)
    k = len(topics)
    if k == 0:
        return {}
    each = total_entries // k
    return {t: each for t in topics}
