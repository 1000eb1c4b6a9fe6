"""Integer-encoded query log and its training statistics.

A copy of ``VecLog`` and ``VecStats`` from ``repro.core.fast`` (numpy):
the cache's planning inputs.  ``VecStats.from_log`` gives the reference's
arrays exactly; its per-topic ranks come from one stable grouping of the
frequency order instead of one full pass over the keys per topic, which
at 96 topics and 68.6M query ids is the difference between seconds and
minutes.  The layouts and trace analytics of ``repro.core.fast`` are not
copied yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..querylog.synth import NO_TOPIC


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
