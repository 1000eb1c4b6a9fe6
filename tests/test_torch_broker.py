"""The port's ``Broker(device="cpu")`` against the JAX ``Broker``, request
for request, on seeded ragged streams.

The JAX reference is the device engine on its jnp path
(``engine="device", use_kernel=False``); the JAX package's own tests hold
that path bit-exact with its Pallas kernels.  Served values, hit masks,
every ``BrokerStats`` counter, the dispatch counts and the state words
after ``flush()`` must agree exactly, on the one-call path and the legacy
``fused_one_call=False`` path, with freshness off, ``miss`` and
``serve_stale_while_revalidate``.  A carry-over case moves a JAX broker's
state into the port mid-stream (``state_from_numpy``) and serves on both.
The same holds on the numpy host engine (``engine="host"`` on both
sides), on the unfused three-call path (``fused=False``), across live
rebalances on a drifting stream (with cooldown and hysteresis, on both
engines) and across key invalidations.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import serving as J  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import serving as T  # noqa: E402

RAGGED = [64, 33, 57, 7, 128, 1, 99, 17, 64]
V = 2


def _backend(q):
    return np.tile(np.asarray(q)[:, None], (1, V)).astype(np.int32)


TOPIC_OF_Q = np.random.default_rng(0).integers(-1, 4, size=500)


def _make(mod, fresh=None, one_call=True, engine="device", **kw):
    cfg = mod.DeviceCacheConfig.build(
        128, f_s=0.1, f_t=0.6, topic_distinct={t: 10 + t for t in range(4)},
        ways=4, value_dim=V,
    )
    static_q = np.array([0, 1])
    if mod is J:
        where = dict(engine=engine, use_kernel=False)
    else:
        where = dict(device="cpu", engine=engine)
    cache = mod.STDDeviceCache(
        cfg, static_hashes=mod.splitmix64(static_q), static_values=_backend(static_q),
        **({} if mod is J else dict(device="cpu")),
    )
    if engine == "device":
        # one explicit bucket keeps the JAX reference to one compiled shape
        kw.setdefault("bucket", mod.BucketSpec(mode="explicit", sizes=(128,)))
    return mod.Broker(
        cache, [_backend], lambda q: TOPIC_OF_Q[q],
        freshness=mod.FreshnessSpec(ttl_s=3.0, stale_policy=fresh) if fresh else None,
        fused_one_call=one_call, **where, **kw,
    )


def _stream(seed=2, reps=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, size=n) for n in RAGGED * reps]


def _serve_both(jb, tb, batches, t0=0.0, between=None):
    for i, q in enumerate(batches):
        for b in (jb, tb):
            b.advance_time(t0 + i + 1.0)
            if between is not None:
                between(i, b)
        v0, h0 = jb.serve(q)
        v1, h1 = tb.serve(q)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1), i
        assert np.array_equal(v1, _backend(q))


def _assert_same_state(jb, tb):
    jb.flush()
    tb.flush()
    mine = T.state_to_numpy(tb.state)
    for k, v in mine.items():
        want = np.asarray(jb.state[k])
        assert want.dtype == v.dtype and np.array_equal(want, v), k


@pytest.mark.parametrize("one_call", [True, False], ids=["one_call", "legacy"])
@pytest.mark.parametrize("fresh", [None, "miss", "serve_stale_while_revalidate"])
def test_broker_matches_jax_request_for_request(one_call, fresh):
    jb, tb = _make(J, fresh, one_call), _make(T, fresh, one_call)
    _serve_both(jb, tb, _stream())
    assert dataclasses.asdict(jb.stats) == dataclasses.asdict(tb.stats)
    assert jb.dispatch_counts == tb.dispatch_counts
    if fresh:
        assert tb.stats.expired > 0
    assert tb.stats.topic_hits > 0 and tb.stats.static_hits > 0
    _assert_same_state(jb, tb)
    jb.close()
    tb.close()


def test_state_carried_over_from_jax_serves_identically():
    spec = "serve_stale_while_revalidate"
    jb, tb = _make(J, spec), _make(T, spec)
    batches = _stream(seed=3)
    for i, q in enumerate(batches[:6]):  # the JAX broker alone
        jb.advance_time(i + 1.0)
        jb.serve(q)
    jb.flush()
    tb.state = T.state_from_numpy({k: np.asarray(v) for k, v in jb.state.items()}, "cpu")
    tb.freshness.load(jb.freshness.tree())
    before = dataclasses.asdict(jb.stats)
    _serve_both(jb, tb, batches[6:], t0=6.0)
    after = dataclasses.asdict(jb.stats)
    delta = {k: after[k] - before[k] for k in after if after[k] is not None}
    assert delta == {k: v for k, v in dataclasses.asdict(tb.stats).items() if v is not None}
    _assert_same_state(jb, tb)


def test_topic_invalidation_and_no_deferred_fill_match_jax():
    def invalidate(i, b):
        if i == 5:
            b.invalidate(topic=2)
        if i == 11:
            b.invalidate(topic=-1)

    jb, tb = _make(J, "miss", defer_fill=False), _make(T, "miss", defer_fill=False)
    _serve_both(jb, tb, _stream(seed=4), between=invalidate)
    assert dataclasses.asdict(jb.stats) == dataclasses.asdict(tb.stats)
    assert tb.stats.invalidations == 2
    _assert_same_state(jb, tb)


def test_fully_hit_batch_is_one_dispatch_and_warmup_touches_nothing():
    tb = _make(T)
    before = T.state_to_numpy(tb.state)
    assert tb.warmup() == tb.warmup_shapes() == _make(J).warmup_shapes()
    assert tb.warmup() == []  # idempotent
    after = T.state_to_numpy(tb.state)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert T.tracing.take() == []  # tracing off: no span
    q = np.random.default_rng(4).integers(0, 500, size=64)
    tb.serve(q)
    _, h = tb.serve(q)
    q = q[h]
    counts = dict(tb.dispatch_counts)
    _, h = tb.serve(q)
    assert h.all()
    delta = {k: tb.dispatch_counts[k] - counts.get(k, 0) for k in tb.dispatch_counts}
    assert {k: d for k, d in delta.items() if d} == {"one_call": 1}
    assert T.tracing.take() == []
    tb.close()
    with pytest.raises(RuntimeError):
        tb.serve(q)


def test_brokers_on_one_cache_own_their_state():
    first = _make(T)
    empty = T.state_to_numpy(first.cache.init_state)
    second = T.Broker(first.cache, [_backend], lambda q: q % 4, device="cpu")
    for q in _stream(seed=5):
        first.serve(q)
    first.flush()
    served = T.state_to_numpy(first.state)
    assert not np.array_equal(served["ks"], empty["ks"])
    for b in (first.cache.init_state, second.state):
        now = T.state_to_numpy(b)
        assert all(np.array_equal(now[k], empty[k]) for k in empty)
    first.close()
    second.close()


def test_what_is_not_ported_raises():
    """Named for the time when ``to_exact`` and ``to_policy`` raised: now
    nothing of the spec raises for want of a port, the exact simulator's
    compilers work (``tests/test_torch_core_exact.py`` holds them to the
    reference), and the broker refuses only bad arguments."""
    spec = T.ServingSpec(cache=TC.CacheSpec.from_strategy("STDv_LRU", 128, 0.1, 0.6))
    exact = spec.cache.to_exact(TC.TrainStats.from_stream([1, 2, 2], {2: 0}))
    # (13, 77, 38) entries; the static layer holds the 2 training keys there are
    assert isinstance(exact, TC.STDCache) and spec.cache.sizes() == (13, 77, 38)
    assert (len(exact.static), exact.sections[0].capacity, exact.dynamic.capacity) == (2, 77, 38)
    gate = TC.AdmissionSpec(kind="polluting").to_policy({}, {}, {})
    assert isinstance(gate, TC.PollutingFilter) and not gate.admits(1)
    cache = _make(T).cache
    args = (cache, [_backend], lambda q: q % 4)
    with pytest.raises(ValueError):
        T.Broker(*args, device="cpu", engine="bogus")
    with pytest.raises(ValueError, match="admission"):
        T.Broker(*args, device="cpu", spec=dataclasses.replace(
            spec.cache, admission=TC.AdmissionSpec(kind="polluting")))
    b = T.Broker(*args, device="cpu")
    with pytest.raises(ValueError, match="RebalanceSpec"):
        b.rebalance()
    with pytest.raises(ValueError, match="FreshnessSpec"):
        b.invalidate(topic=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.Broker(*args)  # the default device is the card
    b.close()


# -- the host engine, the unfused path, rebalancing, key invalidation --------


@pytest.mark.parametrize("fresh", [None, "miss", "serve_stale_while_revalidate"])
@pytest.mark.parametrize("path", ["host", "unfused"])
def test_host_engine_and_unfused_path_match_jax(path, fresh):
    kw = dict(engine="host") if path == "host" else dict(fused=False)
    jb, tb = _make(J, fresh, **kw), _make(T, fresh, **kw)
    assert (tb.engine, tb.fused, tb.defer_fill, tb.fused_one_call) == (
        jb.engine, jb.fused, jb.defer_fill, jb.fused_one_call)
    assert (tb.bucket is None) == (jb.bucket is None)
    assert tb.warmup() == jb.warmup()
    _serve_both(jb, tb, _stream(seed=6))
    assert dataclasses.asdict(jb.stats) == dataclasses.asdict(tb.stats)
    assert jb.dispatch_counts == tb.dispatch_counts
    assert tb.stats.topic_hits > 0
    _assert_same_state(jb, tb)
    jb.close()
    tb.close()


def _drift_stream(seed=7, n=24):
    """Batches whose popularity moves from topics 0-1 to topics 2-3."""
    rng = np.random.default_rng(seed)
    by_topic = [np.flatnonzero(TOPIC_OF_Q == t) for t in range(4)]
    out = []
    for i in range(n):
        hot = (0, 1) if i < n // 2 else (2, 3)
        t = np.where(rng.random(64) < 0.85, rng.choice(hot, 64), rng.integers(0, 4, 64))
        out.append(np.array([rng.choice(by_topic[x][:30]) for x in t]))
    return out


@pytest.mark.parametrize("engine", ["device", "host"])
def test_live_rebalance_with_cooldown_and_hysteresis_matches_jax(engine):
    rb = dict(every=2, decay=0.8, threshold=0.05, min_interval=3, hysteresis=0.2)
    jb = _make(J, "miss", engine=engine, rebalance=J.RebalanceSpec(**rb))
    tb = _make(T, "miss", engine=engine, rebalance=T.RebalanceSpec(**rb))
    batches = _drift_stream()

    def force(i, b):
        if i == 20:
            assert b.rebalance(force=True) in (True, False)

    _serve_both(jb, tb, batches, between=force)
    assert dataclasses.asdict(jb.stats).keys() == dataclasses.asdict(tb.stats).keys()
    for k, v in dataclasses.asdict(jb.stats).items():
        assert np.array_equal(v, getattr(tb.stats, k)), k
    assert tb.stats.rebalances >= 2 and tb.stats.migrated > 0
    assert tb.cache.cfg.to_json() == jb.cache.cfg.to_json()
    assert tb.stats.topic_counts is tb.tracker.counts
    _assert_same_state(jb, tb)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_key_invalidation_matches_jax(engine):
    jb, tb = _make(J, engine=engine), _make(T, engine=engine)
    batches = _stream(seed=8)
    zeroed = []

    def invalidate(i, b):
        if i in (4, 9, 13):
            keys = np.concatenate([batches[i - 1][::2], batches[i - 1][:3]])
            zeroed.append(b.invalidate(keys=keys))

    _serve_both(jb, tb, batches, between=invalidate)
    assert zeroed[0::2] == zeroed[1::2] and sum(zeroed) > 0
    assert dataclasses.asdict(jb.stats) == dataclasses.asdict(tb.stats)
    assert tb.stats.invalidations == sum(zeroed) // 2
    assert tb.invalidate(keys=np.zeros(0, np.int64)) == 0
    _assert_same_state(jb, tb)
