"""The port's span recorder (``repro_torch.serving.tracing``) and the LM
back end's counters.

On the CPU device engine (the kernels' plain versions), with the CLI's LM
back end at gemma-2b's smoke width: tracing changes no answer, no counter
and no state word, at shards 1 and 4 (the shards on threads); every span
lies inside its parent and carries its parent's call, across the
cluster's threads; span times are ``perf_counter_ns`` readings of the
call's own time; with tracing off nothing is recorded.  The back end's
counters on the eager path, and (on a card) the rows of the graph a call
replays.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.fast import VecLog, VecStats  # noqa: E402
from repro_torch.core.spec import CacheSpec  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import BucketSpec, Cluster, ServingSpec, state_to_numpy  # noqa: E402
from repro_torch.serving import tracing  # noqa: E402

MCFG = treg.get_arch("gemma-2b").smoke_config

#: each span's parent
PARENT = {
    "broker.serve": "cluster.serve", "broker.route": "broker.serve",
    "broker.stage": "broker.serve", "broker.launch": "broker.serve",
    "broker.fetch": "broker.serve", "broker.miss": "broker.serve",
    "backend.call": "broker.miss", "backend.tokens": "backend.call",
    "backend.stage": "backend.call", "backend.replay": "backend.call",
    "backend.fetch": "backend.call",
}


@pytest.fixture
def traced():
    """Tracing on for the test, off and cleared after it."""
    tracing.take()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.take()


@pytest.fixture(scope="module")
def params():
    return ttf.init_params(torch.Generator().manual_seed(0), MCFG)


def _stats(seed=0, nq=300, n=3000, n_topics=6):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nq, size=n).astype(np.int64)
    topic = rng.integers(-1, n_topics, size=nq).astype(np.int64)
    seen = np.zeros(nq, bool)
    seen[np.unique(keys[: n // 2])] = True
    topic[~seen] = -1
    return VecStats.from_log(VecLog(keys=keys, n_train=n // 2, key_topic=topic))


def _cluster(params, shards):
    spec = ServingSpec(
        cache=CacheSpec.from_strategy("STDv_LRU", 256, f_s=0.3, f_t=0.5), value_dim=8,
        microbatch=64, engine="device", shards=shards, routing="hash", bucket=BucketSpec())
    backend = tserve.lm_backend(params, MCFG, value_dim=8, device="cpu")
    cluster = Cluster.from_spec(spec, _stats(), [backend], value_fn=backend,
                                parallel=shards > 1, device="cpu")
    cluster.warmup()
    return cluster


def _batches(seed=1, n=6, b=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 300, size=b) for _ in range(n)]


def _serve_all(cluster, batches):
    """Each batch served, with ``perf_counter_ns`` read around each call."""
    out = []
    for q in batches:
        t0 = time.perf_counter_ns()
        v, h = cluster.serve(q)
        out.append((v, h, t0, time.perf_counter_ns()))
    return out


@pytest.mark.parametrize("shards", [1, 4])
def test_tracing_changes_no_answer(params, shards):
    batches = _batches()
    with _cluster(params, shards) as plain:
        want = _serve_all(plain, batches)
        plain.flush()
        assert tracing.take() == []  # off: nothing recorded
        want_stats = dataclasses.asdict(plain.stats)
        want_state = [state_to_numpy(b.state) for b in plain.brokers]
    with _cluster(params, shards) as cl:
        tracing.enable()
        try:
            got = _serve_all(cl, batches)
        finally:
            tracing.disable()
        spans = tracing.take()
        cl.flush()
        for (v0, h0, _, _), (v1, h1, _, _) in zip(want, got):
            assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
        assert dataclasses.asdict(cl.stats) == want_stats
        for a, b in zip(want_state, (state_to_numpy(b.state) for b in cl.brokers)):
            assert all(np.array_equal(a[k], b[k]) for k in a)
    names = {s[0] for s in spans}
    assert set(PARENT) - names == {"backend.stage", "backend.replay"}  # graphs: card only
    assert sum(s[0] == "cluster.serve" for s in spans) == len(batches)


@pytest.mark.parametrize("shards", [1, 4])
def test_spans_nest_and_share_their_call(params, shards, traced):
    batches = _batches(seed=2)
    with _cluster(params, shards) as cl:
        tracing.take()  # the warm-up's spans
        served = _serve_all(cl, batches)
    spans = tracing.take()
    roots = [i for i, s in enumerate(spans) if s[3] < 0]
    assert [spans[i][0] for i in roots] == ["cluster.serve"] * len(batches)
    assert len({spans[i][4] for i in roots}) == len(batches)
    for i, (name, t0, t1, parent, call, n) in enumerate(spans):
        assert 0 < t0 <= t1
        if parent < 0:
            continue
        pname, p0, p1, _, pcall, _ = spans[parent]
        assert parent < i and PARENT[name] == pname, (name, pname)
        assert p0 <= t0 and t1 <= p1 and call == pcall
    # each root's span times fall within the readings taken around its call
    for i, (_, _, t0, t1) in zip(roots, served):
        assert t0 <= spans[i][1] <= spans[i][2] <= t1
        assert spans[i][5] == 64
    per_call = [sum(s[0] == "broker.serve" and s[4] == spans[i][4] for s in spans)
                for i in roots]
    assert max(per_call) == shards  # every shard of a call under its root
    misses = [s for s in spans if s[0] == "broker.miss"]
    calls = [s for s in spans if s[0] == "backend.call"]
    assert misses and sum(s[5] for s in misses) == sum(s[5] for s in calls)


def test_off_records_nothing_and_costs_no_record():
    tracing.take()
    assert tracing.begin("x") is None
    with tracing.span("x") as sp:
        assert sp is None
    f = lambda: 1  # noqa: E731
    assert tracing.bind(f) is f
    assert tracing.take() == []


def test_a_raise_closes_the_spans_inside(traced):
    with pytest.raises(ValueError):
        with tracing.span("outer", 3):
            tracing.begin("left open")
            raise ValueError
    with tracing.span("next"):
        pass
    spans = tracing.take()
    assert [(s[0], s[3], s[5]) for s in spans] == [("outer", -1, 3), ("left open", 0, 0),
                                                   ("next", -1, 0)]
    assert spans[1][2] <= spans[0][2] and spans[0][4] != spans[2][4]


def test_bind_carries_the_parent_into_a_thread(traced):
    def work():
        with tracing.span("child"):
            pass

    with tracing.span("root"):
        th = threading.Thread(target=tracing.bind(work))
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    th = threading.Thread(target=work)  # unbound: a root of its own
    th.start()
    th.join(timeout=10)
    spans = tracing.take()
    assert [(s[0], s[3]) for s in spans] == [("root", -1), ("child", 0), ("child", -1)]
    assert spans[1][4] == spans[0][4] != spans[2][4]


def test_lm_backend_counters_on_the_eager_path(params):
    backend = tserve.lm_backend(params, MCFG, value_dim=8, device="cpu", graph_max=64)
    assert backend.counters == {"calls": 0, "rows": 0, "graph_rows": 0, "eager_calls": 0,
                                "replays": 0, "split_calls": 0, "captures": 0}
    for n in (45, 1, 64, 70):
        backend(np.arange(n))
    c = backend.counters
    assert c["rows"] == c["graph_rows"] == 180
    assert c["calls"] == c["eager_calls"] == 4 and c["captures"] == 0
    assert c["replays"] == c["split_calls"] == 0 and backend.plans == []


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-2b", "arctic-480b"])
def test_lm_backend_counts_the_graph_rows(traced, arch):
    """A call of 45 ids replays its plan: the dense model's cheapest cover
    by the measured replay times, the MoE model's one graph of 64 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    dev = torch.device("cuda")
    cfg = treg.get_arch(arch).smoke_config
    params = ttf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    backend = tserve.lm_backend(params, cfg, value_dim=8, device=dev, graph_max=64)
    tracing.take()
    eager = tserve.lm_backend(params, cfg, value_dim=8, device=dev)
    qids = np.arange(45)
    got = backend(qids)
    plan = backend.plans[45]
    if cfg.moe is not None:
        assert plan == (64,)
        # the padded rows share the experts' capacity: eager on the same 64 rows
        tokens = torch.zeros((64, tserve.QUERY_TOKENS), dtype=torch.int64, device=dev)
        tokens[:45] = torch.from_numpy(tserve.query_tokens(qids, cfg.vocab_size))
        want = tserve.model_scores(params, tokens, cfg, 8)[:45].cpu().numpy()
    else:
        want = eager(qids)
    assert np.array_equal(got, want)
    c = backend.counters
    assert (c["calls"], c["rows"], c["graph_rows"], c["eager_calls"]) == (1, 45, sum(plan), 0)
    assert (c["replays"], c["split_calls"]) == (len(plan), int(len(plan) > 1))
    assert c["captures"] == 7  # 1, 2, ..., 64 rows
    spans = tracing.take()
    assert [(s[0], s[5]) for s in spans if s[3] == 0] == [
        ("backend.tokens", 45), ("backend.stage", 45),
        *[("backend.replay", rows) for rows in plan], ("backend.fetch", 45)]
