"""Freshness-aware caching: TTLs, epochs and invalidation floors.

A copy of ``repro.freshness`` (numpy only): the port keeps its own copy
so that it imports nothing of the JAX package.

Topical result caches answer from stored results; the paper's hit-rate
story implicitly assumes those results never go bad.  Real search
backends re-crawl and re-rank, so a production result cache bounds
*staleness*: a cached entry older than its topic's TTL must not be
served as fresh.  This module is the declarative + host-side half of
that contract:

* :class:`FreshnessSpec` -- the JSON-round-trippable policy riding
  ``ServingSpec`` (in the JAX package; the port's comes in a later
  slice): one default ``ttl_s``,
  per-topic overrides (``topic_ttl_s``), the stale policy (``"miss"``
  re-fetches before answering; ``"serve_stale_while_revalidate"``
  answers from cache immediately and refreshes in the background), and
  the epoch granularity ``tick_s``.
* :class:`FreshnessRuntime` -- the broker's compiled clock.  Virtual
  time (the load harness's arrival clock) quantizes to integer
  *epochs* (``floor(now_s / tick_s)``); every cache write stamps the
  current epoch into the fourth packed state word
  (see docs/freshness.md), and every probe carries one per-request
  ``min_epoch`` floor: an entry is fresh iff ``epoch >= min_epoch``.
  The floor folds two mechanisms into a single in-kernel compare:

  - TTL expiry: ``now_epoch - ttl_ep[partition]``, and
  - topic invalidation: an O(1) per-partition floor bumped to
    ``now_epoch + 1`` by :meth:`FreshnessRuntime.flush_topic` -- the
    whole partition expires without touching a single cache word.

  With every TTL infinite and no floors raised, ``min_epoch`` is zero
  everywhere and the engines are bit-identical to pre-freshness
  serving (conformance-tested), so freshness costs nothing when off.

Numpy-only on purpose: the runtime is host-side control plane; the hot
path only ever sees the two uint32 arrays it emits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import numpy as np

FRESHNESS_SPEC_VERSION = 1

#: sentinel TTL (in epochs) for "never expires" -- large enough that
#: ``now_epoch - ttl_ep`` stays negative for any reachable clock
TTL_EP_INF = 1 << 62

_STALE_POLICIES = ("miss", "serve_stale_while_revalidate")

_EPOCH_MAX = (1 << 32) - 1


@dataclass(frozen=True)
class FreshnessSpec:
    """Declarative freshness policy for a serving tier.

    ``ttl_s``        -- default time-to-live (seconds, virtual time) for
                        dynamic-partition entries and topics without an
                        override; ``inf`` (the default) disables expiry.
    ``topic_ttl_s``  -- per-topic TTL overrides, topic id -> seconds
                        (``inf`` allowed: pin one topic fresh forever
                        under a finite default).
    ``stale_policy`` -- what a broker does with an expired hit:
                        ``"miss"`` treats it as a miss (the backend
                        answers, the entry refreshes -- no stale byte
                        ever leaves the cache), while
                        ``"serve_stale_while_revalidate"`` serves the
                        cached value immediately and refreshes the entry
                        through the deferred-fill plan (bounded
                        staleness bought back as latency).
    ``tick_s``       -- epoch granularity: insertion times quantize to
                        ``floor(t / tick_s)`` so the packed state spends
                        one uint32 word, not a float64, per entry.
    """

    ttl_s: float = math.inf
    topic_ttl_s: Dict[int, float] = field(default_factory=dict)
    stale_policy: str = "miss"
    tick_s: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "ttl_s", float(self.ttl_s))
        object.__setattr__(self, "tick_s", float(self.tick_s))
        object.__setattr__(
            self,
            "topic_ttl_s",
            {int(t): float(s) for t, s in dict(self.topic_ttl_s).items()},
        )
        if not self.ttl_s > 0:
            raise ValueError(f"ttl_s must be > 0, got {self.ttl_s}")
        if not self.tick_s > 0 or not math.isfinite(self.tick_s):
            raise ValueError(f"tick_s must be finite and > 0, got {self.tick_s}")
        if self.stale_policy not in _STALE_POLICIES:
            raise ValueError(
                f"stale_policy must be one of {_STALE_POLICIES}, "
                f"got {self.stale_policy!r}"
            )
        for t, s in self.topic_ttl_s.items():
            if t < 0:
                raise ValueError(f"topic_ttl_s keys must be >= 0, got {t}")
            if not s > 0:
                raise ValueError(f"topic_ttl_s[{t}] must be > 0, got {s}")

    @property
    def enabled(self) -> bool:
        """True when any TTL is finite (invalidation floors work even
        when this is False -- they only need the epoch word)."""
        return math.isfinite(self.ttl_s) or any(
            math.isfinite(s) for s in self.topic_ttl_s.values()
        )

    def ttl_for(self, topic: int) -> float:
        return self.topic_ttl_s.get(int(topic), self.ttl_s)

    @staticmethod
    def from_dict(d: Mapping) -> "FreshnessSpec":
        """Rebuild from a JSON-decoded mapping (string topic keys -- the
        JSON round-trip stringifies dict keys -- are re-intified)."""
        d = dict(d)
        version = d.pop("version", FRESHNESS_SPEC_VERSION)
        if version > FRESHNESS_SPEC_VERSION:
            raise ValueError(
                f"FreshnessSpec version {version} is newer than "
                f"{FRESHNESS_SPEC_VERSION}"
            )
        ttl = d.pop("topic_ttl_s", {})
        return FreshnessSpec(topic_ttl_s={int(t): float(s) for t, s in ttl.items()}, **d)


class FreshnessRuntime:
    """A broker's freshness clock: epochs out, floors in.

    Holds virtual time (``advance``), the per-partition TTLs compiled to
    epoch units, and the per-partition invalidation floors.  Emits the
    two arrays the engines consume:

    * :meth:`epochs` -- the write-epoch stamped into inserted/refreshed
      entries (the current epoch, saturated to uint32), and
    * :meth:`min_epoch` -- per-request freshness floors,
      ``clip(max(now_epoch - ttl_ep[part], floor[part]), 0, 2^32-1)``.

    ``flush_topic`` bumps a partition's floor to ``now_epoch + 1`` *and*
    advances the clock to that epoch, so entries written after the
    invalidation stamp ``now_epoch + 1 >= floor`` and are immediately
    fresh -- O(1) whole-topic expiry with no cache traffic.

    The mutable leaves (``floors``, the clock) checkpoint through
    :meth:`tree` / :meth:`load`; the compiled TTL table is a pure
    function of the spec and rebuilds from it.
    """

    def __init__(self, spec: FreshnessSpec, topic_ids) -> None:
        self.spec = spec
        self.topic_ids = [int(t) for t in topic_ids]
        k = len(self.topic_ids)
        ttl_ep = np.full(k + 1, TTL_EP_INF, np.int64)
        for i, t in enumerate(self.topic_ids):
            ttl = spec.ttl_for(t)
            if math.isfinite(ttl):
                ttl_ep[i] = max(int(math.ceil(ttl / spec.tick_s)), 1)
        if math.isfinite(spec.ttl_s):  # dynamic partition: the default TTL
            ttl_ep[k] = max(int(math.ceil(spec.ttl_s / spec.tick_s)), 1)
        self.ttl_ep = ttl_ep
        #: per-partition invalidation floors (int64 epochs; 0 = never)
        self.floors = np.zeros(k + 1, np.int64)
        self.now_s = 0.0
        #: epoch floor raised by invalidations so post-flush writes stamp
        #: an epoch at or above every floor they must clear
        self._min_now = 0

    @property
    def now_epoch(self) -> int:
        return max(int(self.now_s // self.spec.tick_s), self._min_now)

    def advance(self, t_s: float) -> None:
        """Advance virtual time (monotonic: stale clocks are ignored)."""
        t_s = float(t_s)
        if t_s > self.now_s:
            self.now_s = t_s

    def epochs(self, n: int) -> np.ndarray:
        """(n,) uint32 write-epochs for a batch committed now."""
        return np.full(n, min(self.now_epoch, _EPOCH_MAX), np.uint32)

    def min_epoch(self, parts: np.ndarray) -> np.ndarray:
        """(B,) uint32 freshness floors for a batch probed now."""
        parts = np.clip(np.asarray(parts, np.int64), 0, len(self.ttl_ep) - 1)
        ne = self.now_epoch
        floor = np.maximum(ne - self.ttl_ep[parts], self.floors[parts])
        return np.clip(floor, 0, _EPOCH_MAX).astype(np.uint32)

    def flush_topic(self, part: int) -> None:
        """Expire every entry of one partition, O(1): raise its floor
        above the current epoch and pin the clock there."""
        ne = self.now_epoch + 1
        self.floors[int(part)] = ne
        self._min_now = ne

    def flush_all(self) -> None:
        """Expire the whole cache (every partition), O(k)."""
        ne = self.now_epoch + 1
        self.floors[:] = ne
        self._min_now = ne

    # -- checkpointing ------------------------------------------------------

    def tree(self) -> Dict[str, np.ndarray]:
        """Checkpoint leaves: floors + the clock pair (now_s, _min_now)."""
        return {
            "floors": np.asarray(self.floors, np.int64).copy(),
            "clock": np.asarray([self.now_s, float(self._min_now)], np.float64),
        }

    def load(self, tree: Mapping[str, np.ndarray]) -> None:
        floors = np.asarray(tree["floors"], np.int64)
        if floors.shape != self.floors.shape:
            raise ValueError(
                f"freshness floors shape {floors.shape} does not match this "
                f"runtime's {self.floors.shape} (different topic set?)"
            )
        self.floors[:] = floors
        clock = np.asarray(tree["clock"], np.float64)
        self.now_s = float(clock[0])
        self._min_now = int(clock[1])


def runtime_for(
    spec: Optional[FreshnessSpec], topic_ids
) -> Optional[FreshnessRuntime]:
    """None-propagating constructor (brokers without a spec carry no
    runtime and skip every freshness branch)."""
    return None if spec is None else FreshnessRuntime(spec, topic_ids)


__all__ = [
    "FRESHNESS_SPEC_VERSION",
    "TTL_EP_INF",
    "FreshnessRuntime",
    "FreshnessSpec",
    "runtime_for",
]
