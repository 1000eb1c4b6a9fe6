"""A plain reference of the STD result cache as the serving tier states it,
to judge what the program's device cache served.

The plan is worked out again from the training prefix: the static layer S
holds the ``round(f_s * N)`` most frequent training queries (ties by
lower id); the topic layer T's ``round(f_t * N)`` entries are split over
the topics in proportion to their distinct training queries (largest
remainders, ties by popularity then topic id); the dynamic layer D has the
rest.  Each topic's entries and D are W-way sets (``max(entries // W, 1)``
sets, none for an empty share), laid out topic by topic, D last; a query
goes to its topic's sets, or to D when it has no topic or its topic has no
sets, at set ``h_lo mod sets`` of its 64-bit hash's low word.

Serving a batch: every request is looked up in the state as it was before
the batch (a duplicate inside a batch misses both times); S answers its
keys; then the requests commit one by one in batch order: a resident key
becomes the most recent of its set, any other key takes its set's first
empty way or else its least recent way, and its slot stores the answer it
was served.  A stored answer is readable from the next batch on.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from stream import NO_TOPIC, splitmix64


def split_sizes(n: int, f_s: float, f_t: float):
    s = min(int(round(f_s * n)), n)
    t = min(int(round(f_t * n)), n - s)
    return s, t, n - s - t


def proportional(total: int, distinct: Dict[int, int]) -> Dict[int, int]:
    topics = sorted(distinct)
    counts = np.array([distinct[t] for t in topics], np.float64)
    q = counts.sum()
    if total == 0 or q <= 0:
        return {t: 0 for t in topics}
    shares = total * counts / q
    base = np.floor(shares).astype(np.int64)
    rem = int(total - base.sum())
    if rem > 0:
        order = np.lexsort((np.arange(len(topics)), -counts, -(shares - base)))
        base[order[:rem]] += 1
    return {t: int(s) for t, s in zip(topics, base)}


class Plan:
    """The cache layout of one deployment, from the training prefix."""

    def __init__(self, train_keys: np.ndarray, true_topic: np.ndarray, entries: int,
                 f_s: float, f_t: float, ways: int):
        nq = len(true_topic)
        freq = np.bincount(train_keys, minlength=nq)
        n_s, n_t, n_d = split_sizes(entries, f_s, f_t)
        by_freq = np.lexsort((np.arange(nq), -freq))
        top = by_freq[:n_s]
        self.static_keys = np.sort(top[freq[top] > 0])
        topical = true_topic != NO_TOPIC
        seen = freq > 0
        distinct = {int(t): 0 for t in np.unique(true_topic[topical])}
        ts, cs = np.unique(true_topic[topical & seen], return_counts=True)
        distinct.update({int(t): int(c) for t, c in zip(ts, cs)})
        shares = proportional(n_t, distinct)
        self.topics = sorted(shares)
        sets = [max(shares[t] // ways, 1) if shares[t] > 0 else 0 for t in self.topics]
        sets.append(max(n_d // ways, 1) if n_d > 0 else 0)
        self.sets = np.asarray(sets, np.int64)
        self.offset = np.concatenate([[0], np.cumsum(self.sets)])[:-1]
        self.n_sets = int(self.sets.sum())
        self.ways = ways
        k = len(self.topics)
        part = np.full(nq, k, np.int64)
        for i, t in enumerate(self.topics):
            if self.sets[i] > 0:
                part[true_topic == t] = i
        self.part_of_key = part
        self.static_h = np.sort(splitmix64(self.static_keys))

    def set_of(self, qids: np.ndarray, h64: np.ndarray) -> np.ndarray:
        part = self.part_of_key[qids]
        lo = (h64 & np.uint64(0xFFFFFFFF)).astype(np.int64)
        return self.offset[part] + lo % np.maximum(self.sets[part], 1)

    def is_static(self, h64: np.ndarray) -> np.ndarray:
        if len(self.static_h) == 0:
            return np.zeros(len(h64), bool)
        i = np.minimum(np.searchsorted(self.static_h, h64), len(self.static_h) - 1)
        return self.static_h[i] == h64


class Replay:
    """Replays served batches on the plan; records, for every request, the
    layer that should answer it (0 static, 1 a set, -1 the back end) and,
    for a set hit, which earlier request's answer the slot holds."""

    def __init__(self, plan: Plan):
        self.plan = plan
        s, w = plan.n_sets, plan.ways
        self.key: List[List[int]] = [[0] * w for _ in range(s)]
        self.stamp: List[List[int]] = [[0] * w for _ in range(s)]
        self.src: List[List[int]] = [[-1] * w for _ in range(s)]
        self.where: Dict[int, int] = {}  # resident hash -> way
        self.clock = 0

    def run(self, qids: np.ndarray, bounds: np.ndarray):
        """``qids`` is the served stream in order and ``bounds`` the batch
        edges (``bounds[j]:bounds[j + 1]`` is batch j).  Returns ``(layer,
        src)`` per request: ``src`` is the index, into ``qids``, of the
        request whose answer a set hit must return (-1 otherwise)."""
        h64 = splitmix64(qids)
        static = self.plan.is_static(h64)
        sets = self.plan.set_of(qids, h64).tolist()
        hs = [int(h) for h in h64.tolist()]
        st = static.tolist()
        n = len(qids)
        layer = np.where(static, 0, -1).astype(np.int8)
        src = np.full(n, -1, np.int64)
        hit_row = np.full(n, -1, np.int64)
        inserted = np.zeros(n, bool)
        w_ = self.plan.ways
        key, stamp, srcs, where = self.key, self.stamp, self.src, self.where
        for j in range(len(bounds) - 1):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            for i in range(lo, hi):
                if st[i]:
                    continue
                w = where.get(hs[i])
                if w is not None:
                    layer[i] = 1
                    src[i] = srcs[sets[i]][w]
                    hit_row[i] = sets[i] * w_ + w
            for i in range(lo, hi):
                if st[i]:
                    continue
                self.clock += 1
                h, s = hs[i], sets[i]
                w = where.get(h)
                if w is not None:
                    stamp[s][w] = self.clock
                    continue
                row = stamp[s]
                w = row.index(min(row))
                old = key[s][w]
                if old:
                    del where[old]
                key[s][w] = h
                row[w] = self.clock
                srcs[s][w] = i
                where[h] = w
                inserted[i] = True
        #: per request: its set, the slot a set hit read, whether it wrote
        self.sets = np.asarray(sets, np.int64)
        self.static = static
        self.hit_row = hit_row
        self.inserted = inserted
        return layer, src

    def state(self):
        """``(keys (S, W) uint64, src (S, W) int64)`` of the resident slots."""
        return (np.array(self.key, np.uint64).reshape(self.plan.n_sets, self.plan.ways),
                np.array(self.src, np.int64).reshape(self.plan.n_sets, self.plan.ways))
