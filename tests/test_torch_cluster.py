"""The port's ``Cluster`` on the CPU against the JAX ``Cluster``, state for
state and request for request, on seeded streams.

The JAX reference serves on its numpy host engine; both sides bucket-pad
every shard call to pow2 (``BucketSpec()``: the clock counts the pads), so
the port's device engine (the kernels' plain versions) and its host engine
must land the same state words.  Covered: shards=1 against a bare port
broker; hash and topic routing at shards=4 (values, hit masks, aggregate
and per-shard stats, every shard's state); pipelined ``serve_async`` with
fused groups and cross-batch duplicates (exact duplicate accounting);
threaded against serial dispatch; ``reshard`` 4 -> 2 and 2 -> 4 (state word
for word, the manifest-verified checkpoint); a reshard that must not
resurrect an invalidated topic; key and topic invalidation; rebalancing
then checkpoints across packages both ways, and mismatched restores; a
crash -> recover episode on the virtual clock with the reference's health
events and counters; ``shard_devices``; the kernels' one build under
threads; ``close``.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import core as JC  # noqa: E402
from repro import loadgen as JL  # noqa: E402
from repro import serving as J  # noqa: E402
from repro.querylog import DriftConfig, generate_drifting  # noqa: E402
from repro_torch import loadgen as TL  # noqa: E402
from repro_torch import serving as T  # noqa: E402
from repro_torch.core import fast as TF  # noqa: E402
from repro_torch.core import spec as TC  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import shard_devices  # noqa: E402

PKG = {J: dict(log=JC.VecLog, stats=JC.VecStats, spec=JC.CacheSpec, L=JL),
       T: dict(log=TF.VecLog, stats=TF.VecStats, spec=TC.CacheSpec, L=TL)}


def _backend(qids):
    return np.tile(np.asarray(qids)[:, None], (1, 2)).astype(np.int32)


def _stats(mod, seed=0, nq=300, n=3000, n_topics=6):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nq, size=n).astype(np.int64)
    topic = rng.integers(-1, n_topics, size=nq).astype(np.int64)
    n_train = n // 2
    seen = np.zeros(nq, bool)
    seen[np.unique(keys[:n_train])] = True
    topic[~seen] = -1
    log = PKG[mod]["log"](keys=keys, n_train=n_train, key_topic=topic)
    return log, PKG[mod]["stats"].from_log(log)


def _drift(mod, seed=21, n=12_000, phases=3):
    d = generate_drifting(DriftConfig(n_requests=n, n_topics=12, queries_per_topic=300,
                                      n_notopic_queries=800, n_phases=phases, seed=seed))
    log = PKG[mod]["log"](keys=d.keys, n_train=n // phases, key_topic=d.true_topic)
    return log, PKG[mod]["stats"].from_log(log)


def _spec(mod, n=256, engine="host", **kw):
    kw.setdefault("bucket", mod.BucketSpec())
    cache = PKG[mod]["spec"].from_strategy("STDv_LRU", n, f_s=0.3, f_t=0.5)
    return mod.ServingSpec(cache=cache, value_dim=2, microbatch=64, engine=engine, **kw)


def _cluster(mod, spec, stats, **kw):
    if mod is T:
        kw.setdefault("device", "cpu")
    return mod.Cluster.from_spec(spec, stats, [_backend], value_fn=_backend, **kw)


def _pair(engine="device", seed=0, stats_fn=_stats, spec_kw=None, **kw):
    """A JAX host-engine cluster and the port's (``engine``) on one stream."""
    spec_kw = spec_kw or {}
    logj, sj = stats_fn(J, seed)
    _, st = stats_fn(T, seed)
    jc = _cluster(J, _spec(J, **spec_kw), sj)
    tc = _cluster(T, _spec(T, engine=engine, **spec_kw), st, **kw)
    return logj.test_keys, jc, tc


def _same_state(jc, tc):
    jc.flush()
    tc.flush()
    assert len(jc.brokers) == len(tc.brokers)
    for i, (jb, tb) in enumerate(zip(jc.brokers, tc.brokers)):
        assert jb.cache.cfg.to_json() == tb.cache.cfg.to_json(), i
        mine = T.state_to_numpy(tb.state)
        for k, v in mine.items():
            want = np.asarray(jb.state[k])
            assert want.dtype == v.dtype and np.array_equal(want, v), (i, k)


def _stats_equal(jc, tc):
    assert dataclasses.asdict(jc.stats) == dataclasses.asdict(tc.stats)
    for a, b in zip(jc.shard_stats, tc.shard_stats):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for k in da:
            assert np.array_equal(da[k], db[k]), k


def _serve_both(jc, tc, batches, clock=None):
    for i, q in enumerate(batches):
        if clock is not None:
            jc.advance_time(clock(i))
            tc.advance_time(clock(i))
        v0, h0 = jc.serve(q)
        v1, h1 = tc.serve(q)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1), i
        assert np.array_equal(v1, _backend(q))


def _batches(stream, b=64):
    return [stream[lo : lo + b] for lo in range(0, len(stream), b)]


def _pipelined(cluster, stream, b=64, depth=6):
    values = np.zeros((len(stream), 2), np.int32)
    hit = np.zeros(len(stream), bool)
    starts = list(range(0, len(stream), b))
    for g in range(0, len(starts), depth):
        grp = starts[g : g + depth]
        futs = [cluster.serve_async(stream[lo : lo + b]) for lo in grp]
        for lo, f in zip(grp, futs):
            values[lo : lo + b], hit[lo : lo + b] = f.result()
    return values, hit


# -- shards = 1 ----------------------------------------------------------------


@pytest.mark.parametrize("routing", ["hash", "topic"])
def test_single_shard_cluster_equals_bare_port_broker(routing):
    log, stats = _stats(T, seed=3)
    spec = _spec(T, engine="device", routing=routing)
    bare = T.Broker.from_spec(spec, stats, [_backend], value_fn=_backend, device="cpu")
    with bare, _cluster(T, spec, stats) as cluster:
        assert cluster.brokers[0].cache.cfg == bare.cache.cfg
        for q in _batches(log.test_keys):
            v0, h0 = bare.serve(q)
            v1, h1 = cluster.serve(q)
            assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
        assert dataclasses.asdict(cluster.stats) == dataclasses.asdict(bare.stats)
        assert cluster.dispatch_counts == bare.dispatch_counts
        cluster.warmup()  # tracing off: serving and warm-up record no span
        assert T.tracing.take() == [] and cluster.stats.hits > 0
        bare.flush()
        cluster.flush()
        a, b = T.state_to_numpy(bare.state), T.state_to_numpy(cluster.brokers[0].state)
        assert all(np.array_equal(a[k], b[k]) for k in a)


# -- shards = 4 against the JAX cluster -----------------------------------------


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("routing", ["hash", "topic"])
def test_sharded_cluster_matches_jax(routing, engine):
    stream, jc, tc = _pair(engine, seed=5, spec_kw=dict(shards=4, routing=routing))
    with jc, tc:
        assert tc._pool is None  # one device: no shard threads by default
        _serve_both(jc, tc, _batches(stream))
        _stats_equal(jc, tc)
        _same_state(jc, tc)
        assert tc.stats.topic_hits > 0 and tc.stats.static_hits > 0
        if routing == "topic":
            for i, b in enumerate(tc.brokers):
                assert all(t % 4 == i for t in b.cache.cfg.topic_entries)
        static = tc.spec.cache.device_static_keys(_stats(T, seed=5)[1])
        v, h = tc.serve(static)
        assert h.all() and np.array_equal(v, _backend(static))


@pytest.mark.parametrize("routing", ["hash", "topic"])
def test_serve_async_fused_groups_match_jax(routing):
    log, sj = _stats(J, 11)
    _, st = _stats(T, 11)
    jc = _cluster(J, _spec(J, shards=4, routing=routing, dispatch=J.DispatchSpec(max_fuse=4)), sj)
    tc = _cluster(T, _spec(T, engine="device", shards=4, routing=routing,
                           dispatch=T.DispatchSpec(max_fuse=4)), st)
    # cross-batch duplicates: a repeated block collapses inside fused calls
    stream = log.test_keys
    stream = np.concatenate([stream, stream[:200], stream[100:300]])
    with jc, tc:
        v0, h0 = _pipelined(jc, stream)
        v1, h1 = _pipelined(tc, stream)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
        assert np.array_equal(v1, _backend(stream))
        _stats_equal(jc, tc)
        s = tc.stats
        assert s.requests == len(stream) and tc._dup_stats.requests > 0
        assert tc._dup_stats.coalesced == jc._dup_stats.coalesced > 0
        _same_state(jc, tc)
        # serve() drains its own batch: never fused, the bare broker's path
        q = stream[:64]
        v0, h0 = jc.serve(q)
        v1, h1 = tc.serve(q)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("routing", ["hash", "topic"])
def test_threaded_equals_serial(fused, routing):
    _, st = _stats(T, 13)
    log, _ = _stats(J, 13)
    spec = _spec(T, engine="device", shards=4, routing=routing, fused=fused,
                 dispatch=T.DispatchSpec(max_fuse=3))
    serial = _cluster(T, spec, st, parallel=False)
    threaded = _cluster(T, spec, st, parallel=True)
    with serial, threaded:
        assert serial._pool is None and threaded._pool is not None
        v0, h0 = _pipelined(serial, log.test_keys)
        v1, h1 = _pipelined(threaded, log.test_keys)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
        assert dataclasses.asdict(serial.stats) == dataclasses.asdict(threaded.stats)
        assert serial.dispatch_counts == threaded.dispatch_counts
        serial.flush()
        threaded.flush()
        for a, b in zip(serial.brokers, threaded.brokers):
            x, y = T.state_to_numpy(a.state), T.state_to_numpy(b.state)
            assert all(np.array_equal(x[k], y[k]) for k in x)


# -- elastic resharding ----------------------------------------------------------


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("old,new", [(4, 2), (2, 4)])
def test_reshard_matches_jax_word_for_word(old, new, engine, tmp_path):
    stream, jc, tc = _pair(engine, seed=23, spec_kw=dict(shards=old))
    with jc, tc:
        batches = _batches(stream)
        _serve_both(jc, tc, batches[:16])
        jc.reshard(new)
        tc.reshard(new, ckpt_dir=str(tmp_path), step=7)
        assert tc.spec.shards == len(tc.brokers) == new
        _same_state(jc, tc)
        assert [b.stats.migrated for b in tc.brokers] == [b.stats.migrated for b in jc.brokers]
        assert sum(b.stats.migrated for b in tc.brokers) > 0
        _serve_both(jc, tc, batches[16:])
        _stats_equal(jc, tc)
        _same_state(jc, tc)
        assert tc.restore(str(tmp_path)) == 7
        assert tc.reshard(new) is tc  # same width: nothing moves


def test_reshard_cannot_resurrect_invalidated_topic():
    fresh = dict(shards=2, routing="topic")
    log, sj = _stats(J, 25)
    _, st = _stats(T, 25)
    topics = np.asarray(st.key_topic)[log.test_keys]
    tau = int(topics[topics >= 0][0])
    sel = log.test_keys[topics == tau][:64]
    jc = _cluster(J, _spec(J, freshness=J.FreshnessSpec(ttl_s=1e4), **fresh), sj)
    tc = _cluster(T, _spec(T, engine="device", freshness=T.FreshnessSpec(ttl_s=1e4), **fresh), st)
    with jc, tc:
        _serve_both(jc, tc, _batches(log.test_keys), clock=lambda i: i * 1e-3)
        _, h_warm = tc.serve(sel)
        jc.serve(sel)
        assert h_warm.sum() > 0
        jc.invalidate(topic=tau)
        tc.invalidate(topic=tau)
        jc.reshard(4)
        tc.reshard(4)
        _same_state(jc, tc)
        for b in tc.brokers:  # the floors carried to every new shard
            assert b.freshness.now_s == jc.brokers[0].freshness.now_s
        v0, h0 = jc.serve(sel)
        v1, h1 = tc.serve(sel)
        assert np.array_equal(h0, h1) and np.array_equal(v0, v1)
        assert h1.sum() < h_warm.sum()
        _stats_equal(jc, tc)


@pytest.mark.parametrize("routing", ["hash", "topic"])
def test_invalidation_routes_like_jax(routing):
    log, sj = _stats(J, 31)
    _, st = _stats(T, 31)
    jc = _cluster(J, _spec(J, freshness=J.FreshnessSpec(ttl_s=1e4), shards=3,
                           routing=routing), sj)
    tc = _cluster(T, _spec(T, engine="device", freshness=T.FreshnessSpec(ttl_s=1e4), shards=3,
                           routing=routing), st)
    batches = _batches(log.test_keys)
    with jc, tc:
        for i, q in enumerate(batches):
            _serve_both(jc, tc, [q], clock=lambda _: i * 1e-3)
            if i in (5, 12):
                keys = batches[i - 1][::3]
                assert jc.invalidate(keys=keys) == tc.invalidate(keys=keys)
            if i == 9:
                assert jc.invalidate(topic=2) == tc.invalidate(topic=2) == 0
            if i == 15:
                jc.invalidate(topic=-1)
                tc.invalidate(topic=-1)
        with pytest.raises(ValueError, match="exactly one"):
            tc.invalidate()
        _stats_equal(jc, tc)
        _same_state(jc, tc)
        assert tc.stats.invalidations > 0


# -- rebalancing and checkpoints across packages ---------------------------------


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_rebalanced_checkpoint_round_trips_across_packages(direction, tmp_path):
    rb = dict(every=4, decay=0.95, min_count=20.0)

    def make(mod):
        log, stats = _drift(mod)
        cache = PKG[mod]["spec"].from_strategy("STDv_LRU", 1024, f_s=0.2, f_t=0.6)
        # engine "auto": the JAX host engine on the CPU, the port's device
        # engine (the plain versions); the manifests' specs agree
        spec = mod.ServingSpec(cache=cache, value_dim=2, shards=2, engine="auto",
                               microbatch=256, bucket=mod.BucketSpec(),
                               rebalance=mod.RebalanceSpec(**rb))
        return log, _cluster(mod, spec, stats)

    src_mod, dst_mod = (J, T) if direction == "jax_to_torch" else (T, J)
    log, src = make(src_mod)
    _, dst = make(dst_mod)
    stream = log.test_keys
    with src, dst:
        for q in _batches(stream[:6000], 256):
            src.serve(q)
        src.rebalance(force=True)
        assert src.stats.rebalances > 0
        src.save(str(tmp_path), 9)
        assert dst.restore(str(tmp_path)) == 9
        for a, b in zip(src.brokers, dst.brokers):
            assert a.cache.cfg.to_json() == b.cache.cfg.to_json()
            assert np.array_equal(a.tracker.counts, b.tracker.counts)
        jc, tc = (src, dst) if src_mod is J else (dst, src)
        _stats_equal(jc, tc)
        _same_state(jc, tc)
        _serve_both(jc, tc, _batches(stream[6000:7024], 256))
        _stats_equal(jc, tc)
        _same_state(jc, tc)
        # mismatched deployments fail informatively before any array loads
        _, st = _drift(T)
        for bad, match in ((dict(shards=3), "shards"), (dict(microbatch=128), "different")):
            other = T.ServingSpec.from_json(tc.spec.to_json())
            with _cluster(T, dataclasses.replace(other, **bad), st) as wrong:
                with pytest.raises(ValueError, match=match):
                    wrong.restore(str(tmp_path))
        with pytest.raises(FileNotFoundError, match="manifest"):
            tc.restore(str(tmp_path / "nowhere"))


# -- crash -> recover on the virtual clock ---------------------------------------


def _res(mod):
    return mod.ResilienceSpec(max_retries=2, backoff_base_us=1.0, suspect_after=1,
                              down_after=3, probe_interval_s=0.01, recover_after=1)


@pytest.mark.parametrize("parallel", [False, True])
def test_crash_recover_episode_matches_jax(parallel, tmp_path):
    log, sj = _stats(J, 13)
    _, st = _stats(T, 13)
    jc = _cluster(J, _spec(J, shards=4, resilience=_res(J)), sj)
    tc = _cluster(T, _spec(T, engine="device", shards=4, resilience=_res(T)), st,
                  parallel=parallel)
    batches = _batches(log.test_keys)
    episodes = []
    with jc, tc:
        for mod, c in ((J, jc), (T, tc)):
            d = tmp_path / mod.__name__
            for q in batches[:4]:
                c.serve(q)
            c.save(str(d), step=1)
            fault = PKG[mod]["L"].FaultInjectSpec(crash_at_s=0.002, corrupt_latest=True, seed=1)
            c.inject_shard_faults(2, fault)
        for i, q in enumerate(batches[4:]):
            _serve_both(jc, tc, [q], clock=lambda _: i * 1e-3)
        for c in (jc, tc):
            h = c.shard_health[2]
            assert h.state == J.HEALTHY and h.counters.recoveries >= 1
            episodes.append((tuple(h.events), dataclasses.astuple(h.counters),
                             [x.state for x in c.shard_health]))
        assert episodes[0] == episodes[1]
        assert tc.stats.degraded > 0 and tc.stats.failed_over > 0 and tc.stats.retried > 0
        _stats_equal(jc, tc)
        _same_state(jc, tc)


# -- placement, the kernels' build, lifecycle -------------------------------------


def test_shard_devices():
    assert shard_devices(4, devices=["a", "b"]) == ["a", "b", "a", "b"]
    assert shard_devices(3, devices=["only"]) == ["only"] * 3
    assert shard_devices(2, device="cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="n_shards"):
        shard_devices(0, devices=["a"])
    with pytest.raises(ValueError, match="devices"):
        shard_devices(2, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            shard_devices(2)
        with pytest.raises(RuntimeError):
            T.Cluster.from_spec(_spec(T, engine="device"), _stats(T)[1], [_backend])
    else:
        n = torch.cuda.device_count()
        assert shard_devices(n + 1) == [torch.device("cuda", i % n) for i in range(n + 1)]


def test_first_kernel_build_runs_once_under_threads(monkeypatch):
    calls = []

    def slow_compile():
        calls.append(threading.get_ident())
        time.sleep(0.05)
        return {"cache_ops": ("lib.so", "")}

    monkeypatch.setattr(_build, "_compile_all", slow_compile)
    monkeypatch.setattr(_build, "_LIBS", None)
    out = []
    threads = [threading.Thread(target=lambda: out.append(_build.build_all())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and len(out) == 8 and all(o is out[0] for o in out)
    with pytest.raises(RuntimeError, match="no kernel source"):
        _build.library("missing")


def test_close_is_idempotent_and_serve_after_close_raises():
    _, st = _stats(T, 10)
    cluster = _cluster(T, _spec(T, engine="device", shards=3), st, parallel=True)
    with cluster:
        cluster.serve(np.arange(32))
        assert len(cluster) == 3 and not cluster.closed
    assert cluster.closed and cluster._pool._shutdown
    assert all(b.closed for b in cluster.brokers)
    cluster.close()
    with pytest.raises(RuntimeError, match="close"):
        cluster.serve(np.arange(4))
    with pytest.raises(ValueError, match="shards"):
        T.Cluster(cluster.spec, cluster.brokers[:2], cluster.topic_of)
