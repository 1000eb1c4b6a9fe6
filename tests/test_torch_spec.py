"""The port's specs against the JAX package's, on the CPU.

JSON written by either package must load in the other to an equal spec
(``CacheSpec`` for every strategy, ``ServingSpec`` with every optional
part, ``RebalanceSpec`` and ``ResilienceSpec``), and what the specs compile
to must be equal on the same seeded log: ``to_layout``, ``to_device`` (with
and without a popularity override), ``device_static_keys``,
``DeviceCacheConfig.rebalanced``, ``to_serving_gate``, the shard helpers,
the popularity tracker, the allocation helpers and the resilience state
machine.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import alloc as jalloc  # noqa: E402
from repro.core import fast as jfast  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.serving import rebalance as jreb  # noqa: E402
from repro.serving import resilience as jres  # noqa: E402
from repro.serving import spec as jss  # noqa: E402
from repro_torch.core import alloc as talloc  # noqa: E402
from repro_torch.core import fast as tfast  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.freshness import FreshnessSpec as TFresh  # noqa: E402
from repro_torch.serving import rebalance as treb  # noqa: E402
from repro_torch.serving import resilience as tres  # noqa: E402
from repro_torch.serving import spec as tss  # noqa: E402
from repro.freshness import FreshnessSpec as JFresh  # noqa: E402

N_Q = 3000


def _log(mod, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, size=20000) - 1, N_Q - 1).astype(np.int64)
    key_topic = rng.integers(-1, 6, size=N_Q)
    key_topic[rng.random(N_Q) < 0.3] = -1
    return mod.VecLog(
        keys=keys, n_train=12000, key_topic=key_topic,
        key_terms=rng.integers(1, 9, size=N_Q), key_chars=rng.integers(3, 40, size=N_Q),
    )


def _specs(mod):
    out = [mod.CacheSpec.from_strategy("LRU", 500)]
    for name in mod.STRATEGIES:
        out.append(mod.CacheSpec.from_strategy(name, 500, f_s=0.2, f_t=0.5, f_ts=0.3))
    out.append(dataclasses.replace(
        out[3], admission=mod.AdmissionSpec(kind="polluting", min_train_freq=2)))
    out.append(dataclasses.replace(out[2], admission=mod.AdmissionSpec(kind="singleton_oracle")))
    return out


@pytest.mark.parametrize("i", range(len(jspec.STRATEGIES) + 3))
def test_cache_spec_json_and_compilers_match_jax(i):
    js, ts = _specs(jspec)[i], _specs(tspec)[i]
    assert js.to_json() == ts.to_json()
    assert tspec.CacheSpec.from_json(js.to_json()) == ts
    assert jspec.CacheSpec.from_json(ts.to_json()) == js
    assert js.sizes() == ts.sizes()
    jlog, tlog = _log(jfast), _log(tfast)
    jst, tst = jfast.VecStats.from_log(jlog), tfast.VecStats.from_log(tlog)
    jl, tl = js.to_layout(jst, log=jlog), ts.to_layout(tst, log=tlog)
    assert np.array_equal(jl.key_part, tl.key_part) and jl.capacity == tl.capacity
    assert jl.total_entries() == tl.total_entries()
    for kw in ({}, dict(ways=4, value_dim=3)):
        assert js.to_device(jst.topic_distinct, **kw).to_json() == \
            ts.to_device(tst.topic_distinct, **kw).to_json()
    pop = {0: 5.0, 2: 1.0, 3: 0.5}
    jd = js.to_device(jst.topic_distinct, popularity=pop)
    td = ts.to_device(tst.topic_distinct, popularity=pop)
    assert jd.to_json() == td.to_json()
    assert js.to_device(jst.topic_distinct).rebalanced(pop).to_json() == \
        ts.to_device(tst.topic_distinct).rebalanced(pop).to_json()
    assert np.array_equal(js.device_static_keys(jst), ts.device_static_keys(tst))
    jg = js.admission.to_serving_gate(log=jlog)
    tg = ts.admission.to_serving_gate(log=tlog)
    assert (jg is None) == (tg is None)
    if tg is not None:
        q = np.arange(-3, N_Q + 3)
        assert np.array_equal(jg(q), tg(q))
        assert np.array_equal(js.admission.to_mask(jlog), ts.admission.to_mask(tlog))


def _serving(mod, fresh, full=True):
    cache = mod.CacheSpec.from_strategy("STDv_LRU", 4096, f_s=0.3, f_t=0.5)
    if not full:
        return mod.ServingSpec(cache=cache)
    return mod.ServingSpec(
        cache=cache, shards=4, routing="topic", engine="host", fused=False,
        use_kernel=True, microbatch=512, coalesce=False, value_dim=4, ways=16,
        hedge=mod.HedgeSpec(deadline_s=0.25, max_hedges=2),
        rebalance=mod.RebalanceSpec(every=8, decay=0.9, threshold=0.1, min_count=3,
                                    min_interval=4, hysteresis=0.05),
        bucket=mod.BucketSpec(mode="explicit", sizes=(64, 256), min_size=4),
        batch_policy=mod.BatchPolicySpec(max_batch=128, deadline_us=500.0,
                                         overflow="defer"),
        resilience=mod.ResilienceSpec(timeout_us=100.0, max_retries=3, seed=7,
                                      failover="fail"),
        freshness=fresh(ttl_s=30.0, topic_ttl_s={2: 5.0, 4: 1.0},
                        stale_policy="serve_stale_while_revalidate"),
        dispatch=mod.DispatchSpec(max_fuse=4, fuse_requests=1024),
        fused_one_call=False, aot_warmup=True,
    )


class _NS:
    """The JAX package's serving-spec parts under one name."""

    CacheSpec = jspec.CacheSpec
    ServingSpec = jss.ServingSpec
    HedgeSpec = jss.HedgeSpec
    RebalanceSpec = jreb.RebalanceSpec
    BucketSpec = jss.BucketSpec
    BatchPolicySpec = jss.BatchPolicySpec
    ResilienceSpec = jres.ResilienceSpec
    DispatchSpec = jss.DispatchSpec


class _TS:
    CacheSpec = tspec.CacheSpec
    ServingSpec = tss.ServingSpec
    HedgeSpec = tss.HedgeSpec
    RebalanceSpec = treb.RebalanceSpec
    BucketSpec = tss.BucketSpec
    BatchPolicySpec = tss.BatchPolicySpec
    ResilienceSpec = tres.ResilienceSpec
    DispatchSpec = tss.DispatchSpec


@pytest.mark.parametrize("full", [False, True], ids=["defaults", "every_part"])
def test_serving_spec_json_reads_across_packages(full):
    js, ts = _serving(_NS, JFresh, full), _serving(_TS, TFresh, full)
    assert js.to_json() == ts.to_json()
    assert tss.ServingSpec.from_json(js.to_json()) == ts
    assert jss.ServingSpec.from_json(ts.to_json()) == js
    assert ts.compiled_batch_policy() == tss.BatchPolicySpec(
        **dataclasses.asdict(js.compiled_batch_policy()))
    assert dataclasses.asdict(ts.effective_bucket()) == dataclasses.asdict(js.effective_bucket())
    if full:
        for part in ("rebalance", "resilience", "hedge", "dispatch", "batch_policy"):
            assert dataclasses.asdict(getattr(ts, part)) == dataclasses.asdict(getattr(js, part))
        assert tres.ResilienceSpec.from_json(js.resilience.to_json()) == ts.resilience
        assert jres.ResilienceSpec.from_json(ts.resilience.to_json()) == js.resilience
        assert ts.hedge.to_policy().max_hedges == 2


@pytest.mark.parametrize("routing", ["hash", "topic"])
def test_shard_helpers_match_jax(routing):
    js = dataclasses.replace(_serving(_NS, JFresh, False), shards=3, routing=routing)
    ts = dataclasses.replace(_serving(_TS, TFresh, False), shards=3, routing=routing)
    jst = jfast.VecStats.from_log(_log(jfast))
    rng = np.random.default_rng(3)
    q = rng.integers(0, N_Q, size=500)
    topics = jst.key_topic[q]
    assert np.array_equal(js.shard_of(q, topics), ts.shard_of(q, topics))
    assert [c.to_json() for c in js.device_configs(jst.topic_distinct)] == \
        [c.to_json() for c in ts.device_configs(jst.topic_distinct)]
    for i in range(3):
        assert js.shard_device_config(i, jst.topic_distinct).to_json() == \
            ts.shard_device_config(i, jst.topic_distinct).to_json()
        assert js.shard_cache_spec(i).to_json() == ts.shard_cache_spec(i).to_json()
    assert jss._split_entries(10, 3, 0) == tss._split_entries(10, 3, 0) == 4


def test_tracker_allocation_helpers_and_health_match_jax():
    rng = np.random.default_rng(4)
    jt = jreb.RebalanceSpec(decay=0.9).to_tracker([3, 1, 7])
    tt = treb.RebalanceSpec(decay=0.9).to_tracker([3, 1, 7])
    for _ in range(6):
        topics = rng.integers(-2, 9, size=50)
        jt.observe(topics)
        tt.observe(topics)
    assert np.array_equal(jt.counts, tt.counts) and jt.topic_mass == tt.topic_mass
    assert jt.popularity() == tt.popularity()
    assert jt.allocation(100) == tt.allocation(100)
    tt.load(jt.counts * 2)
    assert np.array_equal(tt.counts, jt.counts * 2)
    a, b = {1: 3, 2: 5, 4: 0}, {1: 1.0, 3: 2.5}
    assert jalloc.allocation_divergence(a, b) == talloc.allocation_divergence(a, b)
    assert talloc.allocation_divergence({}, {}) == 0.0
    assert jalloc.uniform_allocation(103, [5, 2, 9]) == talloc.uniform_allocation(103, [5, 2, 9])
    assert jalloc.proportional_allocation(97, a, exact=True) == \
        talloc.proportional_allocation(97, a, exact=True)
    spec_j = jres.ResilienceSpec(suspect_after=2, down_after=3, recover_after=2, seed=5)
    spec_t = tres.ResilienceSpec(**json.loads(spec_j.to_json()))
    hj, ht = jres.ShardHealth(spec_j), tres.ShardHealth(spec_t)
    for step, ok in enumerate([0, 0, 1, 0, 0, 0, 1, 1, 0, 1, 1]):
        for h in (hj, ht):
            if h.probe_due(step * 0.1):
                h.begin_recovery(step * 0.1)
            (h.record_success if ok else h.record_failure)(step * 0.1)
        assert hj.state == ht.state
    assert hj.events == ht.events and hj.down_spans() == ht.down_spans()
    assert dataclasses.asdict(hj.counters) == dataclasses.asdict(ht.counters)
    assert [spec_j.backoff_s(1, 2, a) for a in range(4)] == \
        [spec_t.backoff_s(1, 2, a) for a in range(4)]
