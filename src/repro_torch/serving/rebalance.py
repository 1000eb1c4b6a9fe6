"""Drift-aware topic rebalancing: online popularity + scheduled live repartition.

A copy of ``repro.serving.rebalance`` (numpy).  The paper's proportional
allocation (Sec. 3.3) sizes each topic's cache partition once, from
*training-log* distinct counts.  Its own premise -- topics have different
and *shifting* temporal-locality patterns -- means the allocation should
follow live popularity:

* :class:`RebalanceSpec` -- a JSON-round-trippable field on
  :class:`~repro_torch.serving.spec.ServingSpec` declaring the tracker
  decay, the trigger cadence (every N served batches) and the divergence
  threshold that gates a migration;
* :class:`PopularityTracker` -- exponentially-decayed per-topic served
  request counts, observed batch by batch on the broker's hot path (one
  bincount per batch) and exposed through ``BrokerStats``.

The runtime half lives on the broker: :meth:`repro_torch.serving.broker.
Broker.rebalance` compiles the tracked counts back through
``proportional_allocation`` and migrates resident entries with
:meth:`repro_torch.serving.device_cache.STDDeviceCache.repartition`, whose
bulk insert runs the ``probe_and_commit`` kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from ..core.alloc import proportional_allocation


@dataclass(frozen=True)
class RebalanceSpec:
    """Declarative drift-tracking + trigger policy for the serving tier.

    ``every``     -- trigger cadence: a rebalance check runs after every
                     N non-empty served batches (``BrokerStats.batches``).
    ``decay``     -- per-batch multiplicative decay of the tracked topic
                     counts; the effective popularity window is roughly
                     ``1 / (1 - decay)`` batches.
    ``threshold`` -- minimum L1 divergence (:func:`repro_torch.core.alloc.
                     allocation_divergence`, range [0, 2]) between the
                     current allocation's shares and the tracked
                     popularity shares before a check actually migrates;
                     0 migrates whenever the integer allocation changed.
    ``min_count`` -- minimum decayed topic-count mass before any
                     rebalance: a cold-started tracker must not shred
                     the training-log allocation on a handful of
                     requests.
    ``min_interval`` -- cooldown: after a migration, scheduled checks
                     skip at least this many served batches before the
                     next migration may run (0 = no cooldown; a manual
                     ``rebalance(force=True)`` bypasses it).  Caps the
                     migration rate outright under oscillating
                     popularity.
    ``hysteresis`` -- threshold band: after a migration the effective
                     threshold is raised to ``threshold + hysteresis``
                     until a scheduled check observes the divergence
                     settled back at or below ``threshold`` (re-arming
                     the plain threshold).  Popularity oscillating just
                     around ``threshold`` then triggers one migration,
                     not one per swing (0 = no band).  With
                     ``threshold == 0`` the band never re-arms, so
                     ``hysteresis`` acts as the post-first-migration
                     threshold.
    """

    every: int = 64
    decay: float = 0.995
    threshold: float = 0.0
    min_count: float = 1.0
    min_interval: int = 0
    hysteresis: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "every", int(self.every))
        object.__setattr__(self, "min_interval", int(self.min_interval))
        for f in ("decay", "threshold", "min_count", "hysteresis"):
            object.__setattr__(self, f, float(getattr(self, f)))
        if self.every < 1:
            raise ValueError(f"rebalance every must be >= 1 batches, got {self.every}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if not 0.0 <= self.threshold <= 2.0:
            raise ValueError(
                f"threshold is an L1 share divergence in [0, 2], got {self.threshold}"
            )
        if self.min_count < 0:
            raise ValueError(f"min_count must be >= 0, got {self.min_count}")
        if self.min_interval < 0:
            raise ValueError(
                f"min_interval must be >= 0 batches, got {self.min_interval}"
            )
        if not 0.0 <= self.hysteresis <= 2.0:
            raise ValueError(
                f"hysteresis is an L1 share divergence band in [0, 2], "
                f"got {self.hysteresis}"
            )

    def to_tracker(self, topic_ids: Sequence[int]) -> "PopularityTracker":
        """Compile to the runtime tracker over a cache's topic universe."""
        return PopularityTracker(topic_ids, decay=self.decay)


class PopularityTracker:
    """Exponentially-decayed served-request counts per topic.

    ``counts`` has one slot per tracked topic (sorted id order) plus a
    trailing bucket for no-topic / untracked traffic (diagnostics only:
    the dynamic layer's size never moves, so the tail bucket is excluded
    from :meth:`allocation`).  The array is shared with
    ``BrokerStats.topic_counts`` and checkpoint round-trips through the
    broker (:meth:`load`).
    """

    def __init__(
        self,
        topic_ids: Sequence[int],
        decay: float,
        counts: Optional[np.ndarray] = None,
    ):
        self.topic_ids = np.asarray(sorted(int(t) for t in topic_ids), np.int64)
        self.decay = float(decay)
        k = len(self.topic_ids)
        self.counts = (
            np.zeros(k + 1, np.float64) if counts is None
            else np.array(counts, np.float64)
        )
        if self.counts.shape != (k + 1,):
            raise ValueError(
                f"tracker counts must have shape ({k + 1},) "
                f"(one per topic + no-topic tail), got {self.counts.shape}"
            )

    def observe(self, topics: np.ndarray) -> None:
        """Fold one served batch's topic ids into the decayed counts."""
        topics = np.asarray(topics, np.int64)
        if len(topics) == 0:
            return
        self.counts *= self.decay
        k = len(self.topic_ids)
        if k == 0:
            self.counts[0] += len(topics)
            return
        idx = np.searchsorted(self.topic_ids, topics)
        idx_c = np.minimum(idx, k - 1)
        known = (topics >= 0) & (idx < k) & (self.topic_ids[idx_c] == topics)
        self.counts += np.bincount(np.where(known, idx_c, k), minlength=k + 1)

    @property
    def topic_mass(self) -> float:
        """Total decayed count over tracked topics (tail bucket excluded)."""
        return float(self.counts[:-1].sum())

    def popularity(self) -> Dict[int, float]:
        """Tracked popularity estimate per topic id."""
        return {int(t): float(c) for t, c in zip(self.topic_ids, self.counts[:-1])}

    def allocation(self, budget: int, min_count: float = 0.0) -> Optional[Dict[int, int]]:
        """Paper-style proportional split of ``budget`` by tracked counts.

        Returns None (no signal) when the decayed mass is below
        ``min_count`` -- the caller keeps the current allocation.
        """
        if len(self.topic_ids) == 0 or self.topic_mass < max(min_count, 1e-9):
            return None
        return proportional_allocation(budget, self.popularity(), exact=True)

    def load(self, counts: np.ndarray) -> None:
        """Restore tracker state in place (checkpoint round-trip)."""
        counts = np.asarray(counts, np.float64)
        if counts.shape != self.counts.shape:
            raise ValueError(
                "checkpointed tracker state has a different topic universe: "
                f"saved shape {counts.shape} vs live {self.counts.shape}"
            )
        self.counts[:] = counts


__all__ = ["PopularityTracker", "RebalanceSpec"]
