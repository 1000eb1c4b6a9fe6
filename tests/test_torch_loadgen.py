"""``repro_torch.loadgen`` against ``repro.loadgen`` on the same seeded
inputs.

Arrival times, plans (``LoadPlan.signature()``, queueing delays, the
makespan), shed and defer accounting, SLO verdicts, fault and latency
schedules and checkpoint corruption must be equal; the port's
``generate_drifting`` / ``generate_invalidations`` equal to the reference's
array for array.  ``run_open_loop`` drives each package's broker and
cluster on the CPU (the numpy host engine on both sides, and the port's
device engine on its plain versions against the reference's host engine):
served, shed and deferred counts, hit rates, every served value and hit
mask, and the per-tenant stats must agree, with invalidation streams and
pipelined dispatch replayed on the same virtual clock.
"""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import core as JC  # noqa: E402
from repro import loadgen as JL  # noqa: E402
from repro import querylog as JQ  # noqa: E402
from repro import serving as JS  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import loadgen as TL  # noqa: E402
from repro_torch import querylog as TQ  # noqa: E402
from repro_torch import serving as TS  # noqa: E402
from repro_torch.core import fast as TF  # noqa: E402
from repro_torch.core import spec as TC  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

PKGS = {
    "jax": dict(L=JL, S=JS, Q=JQ, log=JC.VecLog, stats=JC.VecStats, spec=JC.CacheSpec),
    "torch": dict(L=TL, S=TS, Q=TQ, log=TF.VecLog, stats=TF.VecStats, spec=TC.CacheSpec),
}


def _stats(p, seed=0, nq=300, n=3000, n_topics=6):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nq, size=n).astype(np.int64)
    topic = rng.integers(-1, n_topics, size=nq).astype(np.int64)
    n_train = n // 2
    seen = np.zeros(nq, bool)
    seen[np.unique(keys[:n_train])] = True
    topic[~seen] = -1
    log = p["log"](keys=keys, n_train=n_train, key_topic=topic)
    return log, p["stats"].from_log(log)


def _backend(qids):
    return np.tile(np.asarray(qids)[:, None], (1, 2)).astype(np.int32)


def _arrivals(p, **kw):
    return p["L"].ArrivalSpec(**kw)


@pytest.mark.parametrize("process", ["poisson", "onoff", "deterministic"])
def test_arrival_times_bit_equal(process):
    kw = dict(process=process, rate=20_000.0, burst=3.0, on_frac=0.25, mean_on_s=0.01, seed=5)
    a, b = _arrivals(PKGS["jax"], **kw), _arrivals(PKGS["torch"], **kw)
    assert a.to_json() == b.to_json()
    assert TL.ArrivalSpec.from_json(a.to_json()) == b
    assert np.array_equal(a.times(4000), b.times(4000))
    keys = np.random.default_rng(1).integers(0, 500, 3000)
    w0 = [JL.stamp_arrivals(keys, a), JL.stamp_arrivals(keys[::-1].copy(), a, tenant=0)]
    w1 = [TL.stamp_arrivals(keys, b), TL.stamp_arrivals(keys[::-1].copy(), b, tenant=0)]
    m0, m1 = JL.merge_workloads(w0), TL.merge_workloads(w1)
    for f in ("keys", "t", "tenant"):
        assert np.array_equal(getattr(m0, f), getattr(m1, f)), f
    assert m0.offered_rps == m1.offered_rps and m0.n_tenants == m1.n_tenants == 2


def test_snap_down_equal():
    buckets = [None, (JS.BucketSpec(), TS.BucketSpec()),
               (JS.BucketSpec(min_size=16), TS.BucketSpec(min_size=16)),
               (JS.BucketSpec(mode="explicit", sizes=(8, 96, 512)),
                TS.BucketSpec(mode="explicit", sizes=(8, 96, 512))),
               (JS.BucketSpec(mode="none"), TS.BucketSpec(mode="none"))]
    for bk in buckets:
        jb, tb = bk if bk is not None else (None, None)
        assert [JL.snap_down(jb, k) for k in range(0, 1100)] == [
            TL.snap_down(tb, k) for k in range(0, 1100)]


POLICIES = {
    "deadline": dict(max_batch=64, deadline_us=2_000.0),
    "full_snap": dict(max_batch=100, deadline_us=50_000.0),
    "shed": dict(max_batch=32, deadline_us=500.0, max_queue=48),
    "defer": dict(max_batch=32, deadline_us=500.0, max_queue=48, overflow="defer"),
}


def _plan(p, policy, tenants=1, rate=60_000.0):
    rng = np.random.default_rng(3)
    ws = [p["L"].stamp_arrivals(rng.integers(0, 300, 2500),
                                _arrivals(p, process="onoff" if k else "poisson",
                                          rate=rate, seed=11 + k))
          for k in range(tenants)]
    w = ws[0] if tenants == 1 else p["L"].merge_workloads(ws)
    pol = p["S"].BatchPolicySpec(**POLICIES[policy])
    return p["L"].plan_batches(w, pol, bucket=p["S"].BucketSpec(min_size=8))


@pytest.mark.parametrize("tenants", [1, 2])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_plan_signature_and_accounting_equal(policy, tenants):
    rate = 200_000.0 if policy in ("shed", "defer") else 60_000.0  # past capacity
    a, b = (_plan(PKGS[k], policy, tenants, rate) for k in ("jax", "torch"))
    assert a.signature() == b.signature()
    assert np.array_equal(a.queue_delay_s, b.queue_delay_s, equal_nan=True)
    assert (a.makespan_s, a.pad_slots, a.served) == (b.makespan_s, b.pad_slots, b.served)
    assert [x.padded for x in a.batches] == [x.padded for x in b.batches]
    assert b.served + len(b.shed) == b.n
    if policy == "shed":
        assert len(b.shed) > 0 and len(b.deferred) == 0
    if policy == "defer":
        assert len(b.deferred) > 0 and len(b.shed) == 0
    if policy == "full_snap":
        assert any(x.reason == "full" for x in b.batches)


def _spec(p, engine, shards=None, **kw):
    cache = p["spec"].from_strategy("STDv_LRU", 256, f_s=0.3, f_t=0.5)
    return p["S"].ServingSpec(cache=cache, value_dim=2, engine=engine, microbatch=64,
                              shards=shards or 1, **kw)


def _server(p, kind, engine, **kw):
    log, stats = _stats(p)
    if p is PKGS["torch"]:
        kw["device"] = "cpu"
    if kind == "broker":
        return p["S"].Broker.from_spec(_spec(p, engine), stats, [_backend],
                                       value_fn=_backend, log=log, **kw)
    spec = _spec(p, engine, shards=3, routing="topic",
                 freshness=p["S"].FreshnessSpec(ttl_s=0.05),
                 dispatch=p["S"].DispatchSpec(max_fuse=4))
    return p["S"].Cluster.from_spec(spec, stats, [_backend], value_fn=_backend, log=log,
                                    **kw)


def _invalidations(p):
    q = p["Q"]
    log = q.generate_drifting(q.DriftConfig(n_requests=4000, n_topics=6, queries_per_topic=40,
                                            n_notopic_queries=60, n_phases=2, seed=2))
    stream = q.generate_invalidations(q.InvalidationConfig(topic_rate=3.0, key_rate=40.0,
                                                           seed=4), log)
    # the log spans 2 time units; the workload ~0.1 s: rescale the event times
    stream.times = stream.times * 0.05
    return stream


@pytest.mark.parametrize("kind,engine", [("broker", "host"), ("cluster", "host"),
                                         ("cluster", "device")])
def test_run_open_loop_serves_alike(kind, engine):
    keys = np.random.default_rng(9).integers(0, 300, 3000)
    outs = {}
    for name, p in PKGS.items():
        w = p["L"].stamp_arrivals(keys, _arrivals(p, rate=30_000.0, seed=2))
        pol = p["S"].BatchPolicySpec(max_batch=64, deadline_us=1_500.0, max_queue=200)
        eng = "host" if name == "jax" else engine
        server = _server(p, kind, eng)
        res = p["L"].run_open_loop(
            w, server, pol, bucket=p["S"].BucketSpec(), collect=True,
            invalidations=_invalidations(p) if kind == "cluster" else None,
            pipeline=4 if kind == "cluster" else None,
        )
        outs[name] = (res, res.report(), server)
    (r0, rep0, s0), (r1, rep1, s1) = outs["jax"], outs["torch"]
    assert r0.plan.signature() == r1.plan.signature()
    assert (rep1.n, rep1.served, rep1.shed, rep1.deferred) == (
        rep0.n, rep0.served, rep0.shed, rep0.deferred)
    assert rep1.hit_rate == rep0.hit_rate > 0
    assert np.array_equal(r0.values, r1.values) and np.array_equal(r0.hit, r1.hit)
    st0, st1 = dataclasses.asdict(s0.stats), dataclasses.asdict(s1.stats)
    if engine == "device":  # the port pads to buckets; the host engine does not
        st0.pop("padded"), st1.pop("padded")
    assert st1 == st0
    if kind == "cluster":
        assert st1["invalidations"] > 0 and st1["expired"] > 0
        s0.close()
        s1.close()


def test_slo_spec_json_and_evaluate_equal():
    w = TL.stamp_arrivals(np.arange(500) % 37, TL.ArrivalSpec(rate=200_000.0, seed=3))
    plan = TL.plan_batches(w, TS.BatchPolicySpec(max_batch=16, max_queue=20))
    service = np.where(np.isnan(plan.queue_delay_s), np.nan,
                       np.linspace(1e-4, 5e-3, len(w)))
    res = TL.LoadResult(workload=w, plan=plan, queue_s=plan.queue_delay_s.copy(),
                        service_s=service, wall_serve_s=0.2,
                        stats=[TS.BrokerStats(requests=10, hits=4)])
    rep = res.report()
    for kw in (dict(p99_ms=1.0), dict(p50_ms=100.0, max_shed_rate=0.5),
               dict(p90_ms=2.0, p999_ms=0.5, max_shed_rate=0.0)):
        a, b = JL.SLOSpec(**kw), TL.SLOSpec(**kw)
        assert a.to_json() == b.to_json() and TL.SLOSpec.from_json(a.to_json()) == b
        ra, rb = a.evaluate(rep), b.evaluate(rep)
        assert (ra.ok, ra.violations, ra.describe()) == (rb.ok, rb.violations, rb.describe())
    assert rep.shed > 0 and rep.hit_rate == 0.4


@pytest.mark.parametrize("which", ["drift", "invalidations"])
def test_drift_and_invalidation_generators_equal(which):
    kw = dict(n_requests=6000, n_topics=5, queries_per_topic=50, n_notopic_queries=80,
              n_phases=3, singleton_fraction=0.2, seed=7)
    a = JQ.generate_drifting(JQ.DriftConfig(**kw))
    b = TQ.generate_drifting(TQ.DriftConfig(**kw))
    if which == "drift":
        for f in ("keys", "timestamps", "true_topic", "n_terms", "n_chars"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert b.n_docs == 0 and b.clicks is None
        return
    for ikw in (dict(topic_rate=2.0, key_rate=50.0, seed=1),
                dict(topic_rate=1.0, topics=(1, 3), key_rate=20.0,
                     popularity_weighted=False, seed=2)):
        x = JQ.generate_invalidations(JQ.InvalidationConfig(**ikw), a)
        y = TQ.generate_invalidations(TQ.InvalidationConfig(**ikw), b)
        for f in ("times", "kinds", "targets"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        assert x.take_until(0.7) == y.take_until(0.7) and len(y) > 0


def test_fault_and_latency_schedules_and_corruption_equal(tmp_path):
    kw = dict(error_every=5, error_rate=0.1, timeout_rate=0.15, crash_at_s=0.3,
              latency=dict(delay_s=0.0, every=3, jitter_s=0.0), seed=4)
    a = JL.FaultInjectSpec(**{**kw, "latency": JL.LatencyInjectSpec(**kw["latency"])})
    b = TL.FaultInjectSpec.from_json(a.to_json())
    assert b.to_json() == a.to_json()
    ia, ib = JL.FaultInjector(a), TL.FaultInjector(b)

    def outcome(inj, t):
        try:
            inj.check(t)
            return "ok"
        except Exception as e:  # the injected fault's class name
            return type(e).__name__

    times = np.linspace(0.0, 0.5, 60)
    assert [outcome(ia, t) for t in times] == [outcome(ib, t) for t in times]
    ia.restart(), ib.restart()
    assert outcome(ia, 0.6) == outcome(ib, 0.6)
    assert (ia.errors, ia.timeouts, ia.crashed_calls) == (ib.errors, ib.timeouts, ib.crashed_calls)
    lat = dict(delay_s=0.01, every=2, jitter_s=0.004, seed=3)
    la, lb = JL.LatencyInjectSpec(**lat), TL.LatencyInjectSpec(**lat)
    assert [la.delay_for(c) for c in range(20)] == [lb.delay_for(c) for c in range(20)]
    calls = TL.inject_latency(_backend, TL.LatencyInjectSpec(delay_s=0.0, every=3))
    for _ in range(7):
        calls(np.arange(3))
    assert (calls.calls, calls.delayed) == (7, 3)
    for mode in ("tamper", "truncate"):
        damaged = []
        for mod, ck in ((JL, jckpt), (TL, tckpt)):
            d = str(tmp_path / f"{mod.__name__}_{mode}")
            ck.save(d, 1, {"x": np.arange(100, dtype=np.int32),
                           "y": np.ones((4, 4), np.float32)})
            path = mod.corrupt_checkpoint(os.path.join(d, "step_0000000001"), mode=mode, seed=2)
            assert ck.latest_verified_step(d) is None
            if mode == "tamper":
                with np.load(path) as z:
                    damaged.append({k: z[k].tobytes() for k in z.files})
            else:
                damaged.append(os.path.getsize(path))
        assert damaged[0] == damaged[1]
