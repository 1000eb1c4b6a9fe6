"""The port's exact engine on the host against the JAX package's.

The same seeded streams go through ``repro.core`` and ``repro_torch.core``
(both numpy and per-request Python); the tolerance is 0:

* the policies request by request: hit flags, STD layers and topics, and
  every LRU's ``state()``;
* ``TrainStats``, ``simulate`` with ``track=True`` (per-layer counts and
  miss distances) behind every admission policy;
* ``CacheSpec.to_exact`` and ``AdmissionSpec.to_policy``, with their
  ``ValueError`` cases;
* ``belady_hits`` with ``admit_mask`` and ``bypass``;
* the port's exact simulator equal to its own reuse-distance analysis
  (``device="cpu"``), as ``tests/test_core_equivalence.py`` holds the
  reference's, with unseen keys carrying ``NO_TOPIC``;
* the Bélády case that once failed ``test_belady_dominates``, pinned.
"""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402

STRATEGIES = ("LRU",) + T.STRATEGIES


def _case(seed: int):
    """A stream shaped like ``tests/test_core_equivalence.py``'s: keys over
    8-60 ids, 1-6 topics, unseen keys without a topic, half of it training."""
    rng = np.random.default_rng(seed)
    n_queries = int(rng.integers(8, 61))
    n = int(rng.integers(20, 301))
    n_topics = int(rng.integers(1, 7))
    keys = rng.integers(0, n_queries, size=n).astype(np.int64)
    topic = rng.integers(-1, n_topics, size=n_queries).astype(np.int64)
    n_train = n // 2
    seen = np.zeros(n_queries, bool)
    seen[np.unique(keys[:n_train])] = True
    topic[~seen] = T.NO_TOPIC
    return keys, topic, n_train


def _topic_map(topic):
    return {int(k): int(t) for k, t in enumerate(topic) if t != T.NO_TOPIC}


def _spec(pkg, strategy, n, fs=0.3, ft=0.4, fts=0.5):
    return pkg.CacheSpec.from_strategy(strategy, n, f_s=fs, f_t=ft, f_ts=fts)


def _state(unit):
    """Everything a cache holds, in a form both packages share."""
    name = type(unit).__name__
    if name == "LRUCache":
        return (name, unit.capacity, unit.state())
    if name == "StaticCache":
        return (name, sorted(unit._keys))
    if name == "SDCCache":
        return (name, _state(unit.static), _state(unit.dynamic))
    if name == "STDCache":
        return (name, _state(unit.static), _state(unit.dynamic),
                {t: _state(s) for t, s in sorted(unit.sections.items())})
    return (name, len(unit))


def test_train_stats_equal_reference():
    keys, topic, n_train = _case(5)
    a = J.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
    b = T.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
    assert vars(a) == vars(b)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", [1, 2])
def test_policies_request_by_request(seed, strategy):
    keys, topic, n_train = _case(seed)
    stats = [pkg.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
             for pkg in (J, T)]
    want, got = (_spec(pkg, strategy, 17).to_exact(st) for pkg, st in zip((J, T), stats))
    assert type(got).__name__ == type(want).__name__ and got.capacity == want.capacity
    admit = np.random.default_rng(seed).random(len(keys)) > 0.25
    for k, a in zip(keys.tolist(), admit.tolist()):
        if hasattr(want, "request_ex"):
            w, g = want.request_ex(k, admit=a), got.request_ex(k, admit=a)
            assert (g.hit, g.layer, g.topic) == (w.hit, w.layer, w.topic)
        else:
            assert got.request(k, admit=a) == want.request(k, admit=a)
        assert (k in got) == (k in want) and len(got) == len(want)
    assert _state(got) == _state(want)


def test_lru_null_and_static_units():
    keys = np.random.default_rng(4).integers(0, 12, size=200).tolist()
    for make in (lambda m: m.LRUCache(5), lambda m: m.NullCache(),
                 lambda m: m.StaticCache([1, 3, 5]), lambda m: m.build_lru(0),
                 lambda m: m.build_sdc(6, 0.5, m.TrainStats.from_stream(keys[:100], {}))):
        want, got = make(J), make(T)
        assert [got.request(k) for k in keys] == [want.request(k) for k in keys]
        assert _state(got) == _state(want)
    with pytest.raises(ValueError):
        T.LRUCache(-1)


def _admissions(pkg, keys, n_train, nq):
    rng = np.random.default_rng(8)
    freq = {int(k): int(c) for k, c in zip(*np.unique(keys[:n_train], return_counts=True))}
    terms = {k: int(v) for k, v in enumerate(rng.integers(1, 8, size=nq))}
    chars = {k: int(v) for k, v in enumerate(rng.integers(5, 30, size=nq))}
    return {
        "none": None,
        "all": pkg.AdmitAll(),
        "polluting": pkg.AdmissionSpec("polluting", min_train_freq=2).to_policy(
            train_freq=freq, n_terms=terms, n_chars=chars),
        "oracle": pkg.AdmissionSpec("singleton_oracle").to_policy(stream=keys.tolist()),
    }


@pytest.mark.parametrize("admission", ["none", "all", "polluting", "oracle"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_simulate_tracked_equals_reference(strategy, admission):
    keys, topic, n_train = _case(3)
    out = []
    for pkg in (J, T):
        stats = pkg.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
        cache = _spec(pkg, strategy, 13).to_exact(stats)
        adm = _admissions(pkg, keys, n_train, len(topic))[admission]
        out.append(pkg.simulate(cache, keys[n_train:].tolist(), warm_keys=keys[:n_train].tolist(),
                                admission=adm, track=True))
    want, got = out
    assert vars(got) == vars(want) and got.hit_rate == want.hit_rate
    assert sum(got.layer_requests.values()) == got.requests


def test_build_std_equals_spec_and_reference():
    keys, topic, n_train = _case(6)
    for strategy in T.STRATEGIES:
        caches = []
        for pkg in (J, T):
            stats = pkg.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
            fts = 0.5 if "SDC_" in strategy or strategy == "Tv_SDC" else None
            caches.append(pkg.build_std(strategy, 20, stats, f_s=0.2, f_t=0.5, f_ts=fts))
        assert _state(caches[1]) == _state(caches[0])
    assert T.split_sizes(20, 0.2, 0.5) == J.split_sizes(20, 0.2, 0.5)


def test_to_exact_and_to_policy_raise_like_the_reference():
    keys, topic, n_train = _case(7)
    stats = T.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
    spec = T.CacheSpec(20, admission=T.AdmissionSpec("polluting"))
    with pytest.raises(ValueError, match="non-trivial AdmissionSpec"):
        spec.to_exact(stats)
    assert _state(spec.without_admission().to_exact(stats)) == _state(T.LRUCache(20))
    assert T.AdmissionSpec().to_policy() is None
    with pytest.raises(ValueError, match="polluting admission needs"):
        T.AdmissionSpec("polluting").to_policy(train_freq={})
    with pytest.raises(ValueError, match="needs the full stream"):
        T.AdmissionSpec("singleton_oracle").to_policy()
    pol = T.AdmissionSpec("polluting", 4, 3, 9).to_policy({1: 5}, {1: 2}, {1: 8})
    assert isinstance(pol, T.PollutingFilter)
    assert (pol.min_train_freq, pol.max_terms, pol.max_chars) == (4, 3, 9) and pol.admits(1)
    oracle = T.AdmissionSpec("singleton_oracle").to_policy(stream=keys.tolist())
    assert oracle.singletons == J.SingletonOracle.from_stream(keys.tolist()).singletons


@pytest.mark.parametrize("bypass", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_belady_equals_reference(seed, masked, bypass):
    keys, _, n_train = _case(seed)
    assert np.array_equal(T.next_use_array(keys), J.next_use_array(keys))
    mask = np.random.default_rng(seed).random(len(keys)) > 0.3 if masked else None
    for cap in (0, 1, 3, 9):
        for count_from in (0, n_train):
            got = T.belady_hits(keys, cap, count_from, admit_mask=mask, bypass=bypass)
            assert got == J.belady_hits(keys, cap, count_from, admit_mask=mask, bypass=bypass)
            assert T.belady_hit_rate(keys, cap, count_from, mask, bypass) == J.belady_hit_rate(
                keys, cap, count_from, mask, bypass)


def _exact_and_vectorized(keys, topic, n_train, strategy, n, fs, ft, fts, admitted=None):
    """The port's exact simulator and its analysis on the CPU: hit counts."""
    log = T.VecLog(keys=keys, n_train=n_train, key_topic=topic)
    layout = T.make_layout(strategy, n, T.VecStats.from_log(log), f_s=fs, f_t=ft, f_ts=fts,
                           admitted=admitted)
    ana = T.analyze(log, layout, device="cpu")
    stats = T.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
    cache = (T.build_lru(n) if strategy == "LRU"
             else T.build_std(strategy, n, stats, f_s=fs, f_t=ft, f_ts=fts))

    class Admit:
        def admits(self, k):
            return bool(admitted[k])

    res = T.simulate(cache, keys[n_train:].tolist(), warm_keys=keys[:n_train].tolist(),
                     admission=None if admitted is None else Admit())
    return res.hits, ana.hits(layout.capacity)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", range(4))
def test_exact_equals_own_analysis(seed, strategy):
    keys, topic, n_train = _case(100 + seed)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 49))
    fs = float(rng.choice([0.0, 0.2, 0.5, 0.9]))
    ft = round(float(rng.choice([0.3, 0.8])) * (1 - fs), 4)
    fts = float(rng.choice([0.2, 0.7]))
    exact, fast = _exact_and_vectorized(keys, topic, n_train, strategy, n, fs, ft, fts)
    assert exact == fast


@pytest.mark.parametrize("seed", range(3))
def test_exact_equals_own_analysis_with_admission(seed):
    keys, topic, n_train = _case(200 + seed)
    admitted = np.random.default_rng(seed + 1).random(len(topic)) > 0.4
    exact, fast = _exact_and_vectorized(keys, topic, n_train, "STDv_LRU", 24, 0.3, 0.4, None,
                                        admitted=admitted)
    assert exact == fast


@pytest.mark.parametrize("seed, n, hits, belady, belady_bypass, at_capacity, best_start", [
    # Queue 3's case: 108 keys over ids 0-7, 5 topics, n_train 54; the
    # cache holds 7 entries (topic sections round 2 entries up to 3) and,
    # unlike belady_hits' default, never has to insert a miss
    (0, 6, 49, 48, 49, 51, 48),
    # the topic layer's rounding alone: above Bélády at N even with bypass
    (2102, 6, 28, 26, 26, 28, 26),
])
def test_belady_bounds_std_at_the_entries_it_holds(seed, n, hits, belady, belady_bypass,
                                                   at_capacity, best_start):
    rng = np.random.default_rng(seed)
    if seed == 0:  # the stream test_core_equivalence.py drew
        keys = rng.integers(0, 8, size=108).astype(np.int64)
        topic = rng.integers(-1, 5, size=8).astype(np.int64)
        n_train = 54
        seen = np.zeros(8, bool)
        seen[np.unique(keys[:n_train])] = True
        topic[~seen] = T.NO_TOPIC
    else:
        keys, topic, n_train = _case(seed)
    for pkg in (J, T):
        stats = pkg.TrainStats.from_stream(keys[:n_train].tolist(), _topic_map(topic))
        cache = _spec(pkg, "STDv_LRU", n, fs=0.3, ft=0.4, fts=None).to_exact(stats)
        assert cache.capacity == n + 1
        got = pkg.simulate(cache, keys[n_train:].tolist(), warm_keys=keys[:n_train].tolist())
        assert got.hits == hits
        assert pkg.belady_hits(keys, n, count_from=n_train) == belady < hits
        assert pkg.belady_hits(keys, n, count_from=n_train, bypass=True) == belady_bypass
        assert pkg.belady_hits(keys, cache.capacity, count_from=n_train) == at_capacity
        # the bound holds at the entries the cache holds, with bypass
        assert hits <= pkg.belady_hits(keys, cache.capacity, count_from=n_train, bypass=True)
    # Bélády's state at count_from is not what costs the bound: no start
    # state of n keys gives the suffix more hits
    suffix = keys[n_train:]
    assert max(T.belady_hits(np.concatenate([np.array(start), suffix]), n, count_from=n)
               for start in itertools.combinations(range(int(keys.max()) + 1), n)) == best_start
