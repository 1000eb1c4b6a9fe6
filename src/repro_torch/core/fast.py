"""Vectorized (reuse-distance) trace analytics for every cache strategy.

The port of ``repro.core.fast``.  A query stream and a concrete cache
configuration give a *layout*: each stream position is routed to either

* ``ALWAYS_HIT``  -- key belongs to a (global or per-topic) static set;
* ``NO_CACHE``    -- rejected by a (key-deterministic) admission policy:
  unconditional miss, and invisible to the LRU state of everyone else;
* an LRU partition id (a topic section or the dynamic cache) with a
  capacity.

Within each LRU partition a request hits iff its within-partition reuse
distance is < capacity (Mattson stack property), so one reuse-distance pass
(:mod:`repro_torch.core.rd_offline`) answers the whole configuration --
and, via the per-partition histogram, every *capacity split* of the same
partitioning at once.  :func:`analyze` runs that pass on ``device`` (the
card unless the caller passes ``"cpu"``): the partitioning is three stable
sorts, the reuse distances a sort and a ``searchsorted`` per tree level,
and a :class:`TraceAnalysis` keeps its arrays there.  The hit counts equal
the reference's and the exact simulator's
(:func:`repro_torch.core.simulate.simulate`) integer for integer.

``VecLog``, ``VecStats`` and ``Layout`` are numpy, as in the reference.
``VecStats.from_log`` gives the reference's arrays exactly; its per-topic
ranks come from one stable grouping of the frequency order instead of one
full pass over the keys per topic, which at 96 topics and 68.6M query ids
is the difference between seconds and minutes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..querylog.synth import NO_TOPIC
from .device import resolve_device
from .rd_offline import reuse_distances_offline

# Special partition ids (>= 0 are LRU partitions; topic t -> partition t,
# dynamic cache -> partition DYNAMIC_PART).
ALWAYS_HIT = -1
NO_CACHE = -2
DYNAMIC_PART = 10**9  # sentinel well above any topic id


@dataclass
class VecLog:
    """Integer-encoded query log (train prefix + test suffix)."""

    keys: np.ndarray  # (n,) int64 query ids in [0, n_queries)
    n_train: int
    key_topic: np.ndarray  # (n_queries,) topic id or NO_TOPIC
    #: per-key query-string features for the admission policy
    key_terms: Optional[np.ndarray] = None  # (n_queries,)
    key_chars: Optional[np.ndarray] = None  # (n_queries,)

    @property
    def n(self) -> int:
        return len(self.keys)

    @property
    def n_queries(self) -> int:
        return len(self.key_topic)

    @property
    def test_keys(self) -> np.ndarray:
        return self.keys[self.n_train :]

    @property
    def train_keys(self) -> np.ndarray:
        return self.keys[: self.n_train]


@dataclass
class VecStats:
    """Training statistics, everything indexed by integer key id."""

    train_freq: np.ndarray  # (n_queries,)
    key_topic: np.ndarray  # (n_queries,)
    by_freq: np.ndarray  # key ids sorted by train freq desc (stable)
    freq_rank: np.ndarray  # rank of each key in by_freq (0 = most frequent)
    notopic_rank: np.ndarray  # rank among no-topic keys (or huge)
    topic_rank: np.ndarray  # rank among same-topic keys (or huge)
    topic_distinct: Dict[int, int]  # distinct *training* queries per topic

    @classmethod
    def from_log(cls, log: VecLog) -> "VecStats":
        nq = log.n_queries
        freq = np.bincount(log.train_keys, minlength=nq).astype(np.int64)
        # Stable order: freq desc, first-seen asc (ties broken by key id,
        # which the synthetic generator assigns in first-seen order).
        by_freq = np.lexsort((np.arange(nq), -freq))
        freq_rank = np.empty(nq, dtype=np.int64)
        freq_rank[by_freq] = np.arange(nq)
        topic = np.asarray(log.key_topic)
        seen_in_train = freq > 0

        unranked = np.iinfo(np.int64).max // 2  # larger than any cache size

        # frequency rank among the seen no-topic keys
        notopic_rank = np.full(nq, unranked, dtype=np.int64)
        sel = by_freq[((topic == NO_TOPIC) & seen_in_train)[by_freq]]
        notopic_rank[sel] = np.arange(len(sel))

        # frequency rank among the seen keys of the same topic: group the
        # seen topical keys of the frequency order by topic (a stable sort
        # keeps the frequency order inside each topic)
        topical = topic != NO_TOPIC
        topic_rank = np.full(nq, unranked, dtype=np.int64)
        sel = by_freq[(topical & seen_in_train)[by_freq]]
        grouped = sel[np.argsort(topic[sel], kind="stable")]
        t_of = topic[grouped]
        first = np.searchsorted(t_of, t_of, side="left")
        topic_rank[grouped] = np.arange(len(grouped)) - first
        # every topic that labels a key, seen in training or not
        seen_per_topic = dict(zip(*np.unique(t_of, return_counts=True)))
        topic_distinct = {
            int(t): int(seen_per_topic.get(t, 0)) for t in np.unique(topic[topical])
        }
        return cls(
            train_freq=freq,
            key_topic=topic,
            by_freq=by_freq,
            freq_rank=freq_rank,
            notopic_rank=notopic_rank,
            topic_rank=topic_rank,
            topic_distinct=topic_distinct,
        )


@dataclass
class Layout:
    """A concrete cache configuration, vectorized over keys."""

    #: per-key routing: ALWAYS_HIT / NO_CACHE / partition id
    key_part: np.ndarray
    #: capacity per partition id
    capacity: Dict[int, int]

    def total_entries(self) -> int:
        return sum(self.capacity.values())


def make_layout(
    strategy: str,
    n_entries: int,
    stats: VecStats,
    f_s: float = 0.0,
    f_t: float = 0.0,
    f_ts: Optional[float] = None,
    admitted: Optional[np.ndarray] = None,
) -> Layout:
    """Vectorized twin of :func:`repro_torch.core.build.build_std`: the
    strategy's :class:`~repro_torch.core.spec.CacheSpec` compiled to a
    layout (``CacheSpec.to_layout``)."""
    from .spec import CacheSpec  # deferred: spec imports this module

    spec = CacheSpec.from_strategy(strategy, n_entries, f_s=f_s, f_t=f_t, f_ts=f_ts)
    return spec.to_layout(stats, admitted=admitted)


# ---------------------------------------------------------------------------
# Reuse-distance evaluation
# ---------------------------------------------------------------------------


def partitioned_prev(keys: torch.Tensor, part: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, prev)``: positions renumbered by partition blocks (a stable
    concatenation of the per-partition sub-streams, ``order[j]`` the
    original position of permuted position ``j``), and ``prev[j]`` the
    previous permuted position with the same (partition, key), else -1.
    One reuse-distance pass over ``prev`` then treats every partition as an
    independent cache.  Int64 tensors on ``keys``' device."""
    n = len(keys)
    dev = keys.device
    # dense partition ids keep the partitions' order (DYNAMIC_PART is 10**9)
    _, dense = torch.unique(part, sorted=True, return_inverse=True)
    order = torch.sort(dense, stable=True).indices  # stable by partition
    p_sorted = dense[order]
    k_sorted = keys[order]
    del dense
    # same-key neighbours in (partition, key, permuted position) order:
    # torch has no lexsort, so two stable sorts, the less significant key first
    idx = torch.sort(k_sorted, stable=True).indices
    idx = idx[torch.sort(p_sorted[idx], stable=True).indices]
    kk, pp = k_sorted[idx], p_sorted[idx]
    del k_sorted, p_sorted
    same = torch.zeros(n, dtype=torch.bool, device=dev)
    same[1:] = (kk[1:] == kk[:-1]) & (pp[1:] == pp[:-1])
    del kk, pp
    prev_sorted = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev_sorted[1:] = idx[:-1]
    prev = torch.empty(n, dtype=torch.int64, device=dev)
    prev[idx] = torch.where(same, prev_sorted, -1)
    return order, prev


@dataclass
class TraceAnalysis:
    """Per-position reuse distances for one layout over one stream, as
    tensors on the analysis's device."""

    part_pos: torch.Tensor  # partition id per original position
    rd: torch.Tensor  # reuse distance per original position (-1 first occ)
    count_mask: torch.Tensor  # True on test positions

    def _counted_repeats(self) -> torch.Tensor:
        return self.count_mask & (self.rd >= 0)

    def hits(self, capacity: Dict[int, int]) -> int:
        """Exact hit count on the test suffix for given partition sizes."""
        dev = self.rd.device
        hits = self.static_hits()
        caps = {p: c for p, c in capacity.items() if c > 0}
        if not caps:
            return hits
        ids = torch.tensor(sorted(caps), dtype=torch.int64, device=dev)
        size = torch.tensor([caps[p] for p in sorted(caps)], dtype=torch.int64, device=dev)
        # each position's capacity: its partition's, 0 if it has none
        j = torch.searchsorted(ids, self.part_pos).clamp_(max=len(ids) - 1)
        cap = torch.where(ids[j] == self.part_pos, size[j], 0)
        return hits + int((self._counted_repeats() & (self.rd < cap)).sum())

    def hit_histograms(self, max_cap: int) -> Dict[int, np.ndarray]:
        """cumhist[p][c] = test hits in partition p with capacity c,
        for every c in [0, max_cap] at once: one ``bincount`` over
        (partition, clipped distance) for every partition."""
        parts = torch.unique(self.part_pos)
        parts = parts[(parts != ALWAYS_HIT) & (parts != NO_CACHE)]
        if len(parts) == 0:
            return {}
        sel = self._counted_repeats()
        dense = torch.searchsorted(parts, self.part_pos[sel])
        width = max_cap + 1
        bins = dense * width + self.rd[sel].clamp(0, max_cap)
        del dense, sel
        h = torch.bincount(bins, minlength=len(parts) * width).view(len(parts), width)
        del bins
        zero = torch.zeros(1, dtype=torch.int64, device=h.device)
        return {
            int(p): torch.cat([zero, torch.cumsum(h[i, :max_cap], 0)]).cpu().numpy()
            for i, p in enumerate(parts.tolist())
        }

    def static_hits(self) -> int:
        return int(((self.part_pos == ALWAYS_HIT) & self.count_mask).sum())


def analyze(log: VecLog, layout: Layout, warm: bool = True, device="cuda") -> TraceAnalysis:
    """Route every position, compute within-partition reuse distances, on
    ``device``."""
    dev = resolve_device(device)
    keys = log.keys if warm else log.test_keys
    n_train = log.n_train if warm else 0
    keys = torch.from_numpy(np.asarray(keys, dtype=np.int64)).to(dev)
    key_part = torch.from_numpy(np.asarray(layout.key_part, dtype=np.int64)).to(dev)
    part_pos = key_part[keys]
    del key_part
    count_mask = torch.zeros(len(keys), dtype=torch.bool, device=dev)
    count_mask[n_train:] = True

    live = torch.nonzero((part_pos != ALWAYS_HIT) & (part_pos != NO_CACHE)).squeeze(1)
    rd = torch.full((len(keys),), -1, dtype=torch.int64, device=dev)
    if len(live):
        order, prev = partitioned_prev(keys[live], part_pos[live])
        del keys
        rd_perm = reuse_distances_offline(prev)
        del prev
        # permuted position j is the live position order[j]
        rd[live[order]] = rd_perm
    return TraceAnalysis(part_pos=part_pos, rd=rd, count_mask=count_mask)


def hit_rate(
    log: VecLog,
    layout: Layout,
    warm: bool = True,
    analysis: Optional[TraceAnalysis] = None,
    device="cuda",
) -> float:
    ana = analysis if analysis is not None else analyze(log, layout, warm=warm, device=device)
    n_test = int(ana.count_mask.sum())
    return ana.hits(layout.capacity) / n_test if n_test else 0.0


def lru_hits_all_sizes(log: VecLog, max_cap: int, warm: bool = True, device="cuda") -> np.ndarray:
    """hits[c] for a single LRU of every capacity c in [0, max_cap]."""
    layout = Layout(
        key_part=np.full(log.n_queries, DYNAMIC_PART, dtype=np.int64),
        capacity={DYNAMIC_PART: max_cap},
    )
    ana = analyze(log, layout, warm=warm, device=device)
    return ana.hit_histograms(max_cap)[DYNAMIC_PART]
