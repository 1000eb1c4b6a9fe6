"""Bélády's optimal (clairvoyant) replacement policy, offline: a copy of
``repro.core.belady``, sequential Python on the host.

Upper bound used by the paper (RQ3): on a miss with a full cache, evict the
resident key whose next request is farthest in the future.  Implemented with
a precomputed next-use array plus a lazy max-heap: O(n log n).

``admit_mask`` implements admission policies on top of Bélády (Tables 5/7:
the optimal cache is also run behind the polluting-filter / singleton
oracle): positions with ``admit_mask[i] == False`` never insert (they still
hit if the key is resident, which for singleton filtering never happens).
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

INF = np.iinfo(np.int64).max


def next_use_array(keys: np.ndarray) -> np.ndarray:
    """next_use[i] = next position of keys[i] after i, or INF."""
    n = len(keys)
    nxt = np.full(n, INF, dtype=np.int64)
    last: dict = {}
    for i in range(n - 1, -1, -1):
        k = keys[i]
        nxt[i] = last.get(k, INF)
        last[k] = i
    return nxt


def belady_hits(
    keys: np.ndarray,
    capacity: int,
    count_from: int = 0,
    admit_mask: Optional[np.ndarray] = None,
    bypass: bool = False,
) -> int:
    """Number of hits at positions >= count_from under Bélády replacement.

    The full stream (including the warm-up prefix ``[0, count_from)``) is
    processed; hits are only *counted* on the suffix, matching the paper's
    train-warm / test-measure protocol.

    ``bypass=True`` additionally lets the clairvoyant cache *decline to
    insert* a miss whose next use is farther than every resident's (the
    optimal-admission upper bound used for the paper's Tables 5/7, where
    mandatory insertion of singletons would cost the bound real hits).
    """
    keys = np.asarray(keys)
    n = len(keys)
    if capacity <= 0:
        return 0
    nxt = next_use_array(keys)
    in_cache: dict = {}  # key -> next use (authoritative)
    heap: list = []  # (-next_use, key) lazy entries
    hits = 0
    for i in range(n):
        k = keys[i]
        resident = k in in_cache
        if resident:
            if i >= count_from:
                hits += 1
        else:
            if admit_mask is not None and not admit_mask[i]:
                continue
            if len(in_cache) >= capacity:
                # Lazy-clean the heap top to the authoritative next-use.
                while True:
                    neg_nu, ek = heap[0]
                    if in_cache.get(ek) == -neg_nu:
                        break
                    heapq.heappop(heap)
                if bypass and int(nxt[i]) >= -heap[0][0]:
                    continue  # current item is the best eviction victim
                heapq.heappop(heap)
                del in_cache[ek]
        # (Re)insert with updated priority; stale heap entries are skipped
        # at eviction time.
        in_cache[k] = int(nxt[i])
        heapq.heappush(heap, (-int(nxt[i]), k))
    return hits


def belady_hit_rate(
    keys: np.ndarray,
    capacity: int,
    count_from: int = 0,
    admit_mask: Optional[np.ndarray] = None,
    bypass: bool = False,
) -> float:
    n_test = len(keys) - count_from
    if n_test <= 0:
        return 0.0
    return belady_hits(keys, capacity, count_from, admit_mask, bypass) / n_test
