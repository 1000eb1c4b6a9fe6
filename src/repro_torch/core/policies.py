"""Exact (per-request) cache policies from the paper.

A copy of ``repro.core.policies``.  These are the reference semantics: every
policy processes one request at a time on the host, exactly as the paper's
simulator does.  The reuse-distance engine (:mod:`repro_torch.core.fast`,
on the card) is held equal to these classes by the port's tests.

Terminology follows the paper (Mele et al., "Topical Result Caching in Web
Search Engines"):

* ``S``  -- static cache: preloaded with the most frequent training queries,
  read-only during the test stream.
* ``T``  -- topic cache: ``k`` independent per-topic sections, each an LRU or
  an SDC.  Section sizes are uniform (``STDf``) or proportional to topic
  popularity (``STDv``).
* ``D``  -- dynamic cache: plain LRU for queries without a topic.

Keys are opaque hashables; the benchmarks use integer-encoded query ids.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, Iterable, Mapping, Sequence

from ..querylog.synth import NO_TOPIC

Key = Hashable


class CacheUnit:
    """Interface shared by every cache component.

    ``request`` performs one full cache transaction: probe, update recency
    on a hit, and (optionally, when ``admit`` is true) insert on a miss,
    applying the eviction policy.  It returns True on a hit.
    """

    def request(self, key: Key, admit: bool = True) -> bool:  # pragma: no cover
        raise NotImplementedError

    def __contains__(self, key: Key) -> bool:  # pragma: no cover
        raise NotImplementedError

    def __len__(self) -> int:  # pragma: no cover
        raise NotImplementedError


class NullCache(CacheUnit):
    """Capacity-0 cache: every request is a miss (paper: sections may round
    down to zero entries)."""

    capacity = 0

    def request(self, key: Key, admit: bool = True) -> bool:
        return False

    def __contains__(self, key: Key) -> bool:
        return False

    def __len__(self) -> int:
        return 0


class LRUCache(CacheUnit):
    """Classic LRU with O(1) request via an ordered dict."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._od: "collections.OrderedDict[Key, None]" = collections.OrderedDict()

    def request(self, key: Key, admit: bool = True) -> bool:
        od = self._od
        if key in od:
            od.move_to_end(key)
            return True
        if admit and self.capacity > 0:
            od[key] = None
            if len(od) > self.capacity:
                od.popitem(last=False)
        return False

    def warm(self, keys: Iterable[Key]) -> None:
        for k in keys:
            self.request(k)

    def __contains__(self, key: Key) -> bool:
        return key in self._od

    def __len__(self) -> int:
        return len(self._od)

    def state(self) -> list:
        """LRU -> MRU ordering (for checkpoint tests)."""
        return list(self._od.keys())


class StaticCache(CacheUnit):
    """Read-only membership cache, preloaded offline."""

    def __init__(self, keys: Iterable[Key]):
        self._keys = frozenset(keys)
        self.capacity = len(self._keys)

    def request(self, key: Key, admit: bool = True) -> bool:
        return key in self._keys

    def __contains__(self, key: Key) -> bool:
        return key in self._keys

    def __len__(self) -> int:
        return len(self._keys)


class SDCCache(CacheUnit):
    """Static-Dynamic Cache [Fagni et al. 2006]: probe S, fall back to LRU."""

    def __init__(self, static_keys: Iterable[Key], dynamic_capacity: int):
        self.static = StaticCache(static_keys)
        self.dynamic: CacheUnit = (
            LRUCache(dynamic_capacity) if dynamic_capacity > 0 else NullCache()
        )
        self.capacity = self.static.capacity + dynamic_capacity

    def request(self, key: Key, admit: bool = True) -> bool:
        if key in self.static:
            return True
        return self.dynamic.request(key, admit=admit)

    def warm(self, keys: Iterable[Key]) -> None:
        for k in keys:
            self.request(k)

    def __contains__(self, key: Key) -> bool:
        return key in self.static or key in self.dynamic

    def __len__(self) -> int:
        return len(self.static) + len(self.dynamic)


@dataclass
class STDResult:
    hit: bool
    layer: str  # "static" | "topic" | "dynamic"
    topic: int  # NO_TOPIC when handled by S or D


class STDCache(CacheUnit):
    """Static-Topic-Dynamic cache (paper Alg. 1).

    ``topic_of`` maps a key to its topic id or ``NO_TOPIC``.  ``sections``
    maps topic id -> CacheUnit (LRU or SDC).  A query whose topic has no
    section (e.g. the topic received 0 entries) falls through to the
    dynamic cache, mirroring the paper's treatment of unassigned queries.
    """

    def __init__(
        self,
        static_keys: Iterable[Key],
        sections: Mapping[int, CacheUnit],
        dynamic_capacity: int,
        topic_of: Callable[[Key], int],
    ):
        self.static = StaticCache(static_keys)
        self.sections: Dict[int, CacheUnit] = dict(sections)
        self.dynamic: CacheUnit = (
            LRUCache(dynamic_capacity) if dynamic_capacity > 0 else NullCache()
        )
        self.topic_of = topic_of
        self.capacity = (
            self.static.capacity
            + sum(getattr(c, "capacity", 0) for c in self.sections.values())
            + dynamic_capacity
        )

    def request(self, key: Key, admit: bool = True) -> bool:
        return self.request_ex(key, admit=admit).hit

    def request_ex(self, key: Key, admit: bool = True) -> STDResult:
        if key in self.static:
            return STDResult(True, "static", NO_TOPIC)
        topic = self.topic_of(key)
        if topic != NO_TOPIC:
            section = self.sections.get(topic)
            # a topic with zero entries is "not handled by the cache"
            # (paper Alg. 1): its queries compete for the dynamic cache --
            # with f_t = 0 the STD cache degenerates exactly to SDC.
            if section is not None and getattr(section, "capacity", 0) > 0:
                return STDResult(section.request(key, admit=admit), "topic", topic)
        return STDResult(self.dynamic.request(key, admit=admit), "dynamic", NO_TOPIC)

    def warm(self, keys: Iterable[Key]) -> None:
        for k in keys:
            self.request(k)

    def __contains__(self, key: Key) -> bool:
        if key in self.static:
            return True
        topic = self.topic_of(key)
        if topic != NO_TOPIC and topic in self.sections:
            return key in self.sections[topic]
        return key in self.dynamic

    def __len__(self) -> int:
        return (
            len(self.static)
            + sum(len(c) for c in self.sections.values())
            + len(self.dynamic)
        )


# ---------------------------------------------------------------------------
# Admission policies (paper Sec. 5, RQ4)
# ---------------------------------------------------------------------------


class AdmissionPolicy:
    """Decides whether a missed query's results may enter the cache."""

    def admits(self, key: Key) -> bool:  # pragma: no cover
        raise NotImplementedError


class AdmitAll(AdmissionPolicy):
    def admits(self, key: Key) -> bool:
        return True


@dataclass
class PollutingFilter(AdmissionPolicy):
    """Stateful + stateless admission policy of Baeza-Yates et al. [5].

    A query is admitted only if (paper Sec. 5):
      * training frequency >= ``min_train_freq``   (stateful, X=3)
      * number of terms     <  ``max_terms``       (stateless, Y=5)
      * number of chars     <  ``max_chars``       (stateless, Z=20)
    """

    train_freq: Mapping[Key, int]
    n_terms: Mapping[Key, int]
    n_chars: Mapping[Key, int]
    min_train_freq: int = 3
    max_terms: int = 5
    max_chars: int = 20

    def admits(self, key: Key) -> bool:
        return (
            self.train_freq.get(key, 0) >= self.min_train_freq
            and self.n_terms.get(key, 1) < self.max_terms
            and self.n_chars.get(key, 1) < self.max_chars
        )


@dataclass
class SingletonOracle(AdmissionPolicy):
    """Clairvoyant admission: never admit queries occurring exactly once in
    the full stream (paper's oracle upper bound for admission policies)."""

    singletons: frozenset = field(default_factory=frozenset)

    @classmethod
    def from_stream(cls, stream: Sequence[Key]) -> "SingletonOracle":
        counts = collections.Counter(stream)
        return cls(frozenset(k for k, c in counts.items() if c == 1))

    def admits(self, key: Key) -> bool:
        return key not in self.singletons
