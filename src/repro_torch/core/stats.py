"""Training-split statistics consumed by the cache constructors (a copy of
``repro.core.stats``).

Everything the paper derives from the training portion of a query log:
query frequencies (for the static cache), query->topic assignment (from the
LDA pipeline), per-topic distinct-query counts (topic popularity) and
per-topic frequency rankings (for the static fraction of per-topic SDCs).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence

from .policies import NO_TOPIC, Key


@dataclass
class TrainStats:
    query_freq: Dict[Key, int]
    topic_of: Dict[Key, int]  # keys absent -> NO_TOPIC
    #: distinct-query count per topic (topic popularity, paper Sec. 3.3)
    topic_distinct: Dict[int, int] = field(default_factory=dict)
    #: queries sorted by training frequency, descending (stable)
    by_freq: List[Key] = field(default_factory=list)
    #: per-topic queries sorted by training frequency, descending
    topic_by_freq: Dict[int, List[Key]] = field(default_factory=dict)
    #: no-topic queries sorted by training frequency, descending
    notopic_by_freq: List[Key] = field(default_factory=list)

    def topic(self, key: Key) -> int:
        return self.topic_of.get(key, NO_TOPIC)

    @property
    def topics(self) -> List[int]:
        return sorted(self.topic_distinct)

    @classmethod
    def from_stream(
        cls,
        train_keys: Sequence[Key],
        topic_of: Mapping[Key, int],
    ) -> "TrainStats":
        freq = collections.Counter(train_keys)
        topic_map = {
            k: t for k, t in topic_of.items() if t != NO_TOPIC and k in freq
        }
        # Sort: frequency desc, key asc.  The tie-break is arbitrary for the
        # paper ("top frequent queries"); keeping it deterministic on the key
        # makes the exact and vectorized simulators bit-identical.
        by_freq = sorted(freq, key=lambda k: (-freq[k], k))
        topic_distinct: Dict[int, int] = collections.Counter()
        topic_by_freq: Dict[int, List[Key]] = collections.defaultdict(list)
        notopic_by_freq: List[Key] = []
        for k in by_freq:
            t = topic_map.get(k, NO_TOPIC)
            if t == NO_TOPIC:
                notopic_by_freq.append(k)
            else:
                topic_distinct[t] += 1
                topic_by_freq[t].append(k)
        return cls(
            query_freq=dict(freq),
            topic_of=topic_map,
            topic_distinct=dict(topic_distinct),
            by_freq=by_freq,
            topic_by_freq=dict(topic_by_freq),
            notopic_by_freq=notopic_by_freq,
        )
