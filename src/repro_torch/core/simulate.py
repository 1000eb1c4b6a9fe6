"""Sequential trace replay (the paper's simulation protocol), a copy
of ``repro.core.simulate``: per-request Python on the host.

Replays the training stream to (1) warm the LRU portions and then measures
hit rate on the test stream, optionally behind an admission policy.  Also
computes the per-topic average miss distance diagnostic of paper Fig. 6.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from .policies import NO_TOPIC, AdmissionPolicy, CacheUnit, SDCCache, STDCache


@dataclass
class SimResult:
    hits: int
    requests: int
    layer_hits: Dict[str, int] = field(default_factory=dict)
    layer_requests: Dict[str, int] = field(default_factory=dict)
    #: avg #queries strictly between consecutive misses of the same key,
    #: aggregated per topic (NO_TOPIC = the dynamic cache), paper Fig. 6.
    avg_miss_distance: Dict[int, float] = field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else 0.0


def simulate(
    cache: CacheUnit,
    test_keys: Sequence,
    warm_keys: Sequence = (),
    admission: Optional[AdmissionPolicy] = None,
    track: bool = False,
) -> SimResult:
    """Warm with ``warm_keys`` (admission applies there too — the policy is a
    property of the cache manager, not of the measurement phase), then replay
    ``test_keys`` counting hits.

    With ``track=True`` the per-layer dicts are populated for every cache
    type: STD caches report static/topic/dynamic, SDC caches static/dynamic,
    and everything else (LRU, ...) counts under "dynamic"."""
    is_std = isinstance(cache, STDCache)
    is_sdc = isinstance(cache, SDCCache)

    def admit_ok(k) -> bool:
        return admission is None or admission.admits(k)

    for k in warm_keys:
        cache.request(k, admit=admit_ok(k))

    hits = 0
    layer_hits: Dict[str, int] = {"static": 0, "topic": 0, "dynamic": 0}
    layer_requests: Dict[str, int] = {"static": 0, "topic": 0, "dynamic": 0}
    # miss-distance bookkeeping: last miss position per key, accumulators per
    # topic (NO_TOPIC aggregates the dynamic cache).
    last_miss: Dict = {}
    dist_sum: Dict[int, int] = {}
    dist_cnt: Dict[int, int] = {}

    for i, k in enumerate(test_keys):
        if is_std:
            res = cache.request_ex(k, admit=admit_ok(k))
            hit = res.hit
            if track:
                layer_requests[res.layer] += 1
                if hit:
                    layer_hits[res.layer] += 1
                elif res.layer != "static":
                    topic = res.topic if res.layer == "topic" else NO_TOPIC
                    j = last_miss.get(k)
                    if j is not None:
                        dist_sum[topic] = dist_sum.get(topic, 0) + (i - j - 1)
                        dist_cnt[topic] = dist_cnt.get(topic, 0) + 1
                    last_miss[k] = i
        else:
            # layer attribution for non-STD caches: an SDC splits into its
            # static membership vs the LRU part; anything else is "dynamic"
            in_static = is_sdc and track and k in cache.static
            hit = cache.request(k, admit=admit_ok(k))
            if track:
                layer = "static" if in_static else "dynamic"
                layer_requests[layer] += 1
                if hit:
                    layer_hits[layer] += 1
                else:
                    j = last_miss.get(k)
                    if j is not None:
                        dist_sum[NO_TOPIC] = dist_sum.get(NO_TOPIC, 0) + (i - j - 1)
                        dist_cnt[NO_TOPIC] = dist_cnt.get(NO_TOPIC, 0) + 1
                    last_miss[k] = i
        hits += hit

    avg_dist = {
        t: dist_sum[t] / dist_cnt[t] for t in dist_sum if dist_cnt.get(t)
    }
    return SimResult(
        hits=hits,
        requests=len(test_keys),
        layer_hits=layer_hits if track else {},
        layer_requests=layer_requests if track else {},
        avg_miss_distance=avg_dist,
    )
