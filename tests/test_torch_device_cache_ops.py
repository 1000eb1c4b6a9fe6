"""The port's device-cache engines against the JAX ``STDDeviceCache``, on
the CPU, state for state.

Three engines commit a batch: the sequential oracle (``commit``), the
vectorized commit (``commit_vectorized``: the ``probe_and_commit`` op, its
plain version here) and the numpy host engine (``commit_host``,
``probe_and_commit_host``, ``fill_values_host``).  Each runs a chain of
evolving seeded batches -- pads, duplicates, static hits, non-admitted
misses, stale hits with epochs on both sides of 2**31, a batch 80 deep in
one set -- against the JAX cache on its jnp engine (jitted; its Pallas
kernels are held to that path by its own tests) for the vectorized commit
and on its host engine for the other two, and every state must be equal
word for word (tolerance 0).  Then the elastic
ops: ``repartition`` (a topic grown, one shrunk, one given no entries) on
all three engines with and without the migration bucket, ``extract_live``,
``bulk_insert`` and ``invalidate_keys``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.serving import device_cache as jdc  # noqa: E402
from repro.serving.spec import BucketSpec as JBucket  # noqa: E402
from repro_torch.serving import device_cache as tdc  # noqa: E402
from repro_torch.serving.spec import BucketSpec as TBucket  # noqa: E402

W, V, N_Q = 4, 3, 400
#: topic 0 owns one set, so its requests form deep segments
TOPIC_ENTRIES = {0: 4, 1: 40, 2: 60, 3: 32, 4: 20}
BATCH = 96
ENGINES = ("oracle", "vec", "host")
#: the JAX engine each port engine is held to (the JAX package holds its
#: own engines bit-exact with each other)
JAX_ENGINE = {"oracle": "host", "vec": "vec", "host": "host"}


def _cfg(mod):
    return mod.DeviceCacheConfig(
        total_entries=256, ways=W, value_dim=V, topic_entries=dict(TOPIC_ENTRIES),
        dynamic_entries=68, static_entries=32,
    )


def _universe(seed=0):
    rng = np.random.default_rng(seed)
    topic_of = rng.integers(-1, 5, size=N_Q)
    static_q = np.arange(0, 32)
    return topic_of, static_q


def _backend(q):
    q = np.asarray(q, np.int64)
    return (q[:, None] * 7 + np.arange(V)[None, :]).astype(np.int32)


def _caches(cfg_j=None, cfg_t=None):
    _, static_q = _universe()
    h = jdc.splitmix64(static_q)
    jc = jdc.STDDeviceCache(cfg_j or _cfg(jdc), static_hashes=h, static_values=_backend(static_q))
    tc = tdc.STDDeviceCache(cfg_t or _cfg(tdc), static_hashes=h,
                            static_values=_backend(static_q), device="cpu")
    return jc, tc


def _batch(cache, seed, deep=False):
    """One seeded request batch as host arrays: (h_hi, h_lo, parts, values,
    admit, epochs, min_epoch)."""
    topic_of, _ = _universe()
    rng = np.random.default_rng(100 + seed)
    q = rng.integers(0, N_Q, size=BATCH)
    if deep:  # 80 requests of topic 0 (one set), a few repeating
        t0 = np.flatnonzero(topic_of == 0)
        q[:80] = rng.choice(t0[:24], size=80)
    q[rng.random(BATCH) < 0.15] = q[0]  # duplicates
    h_hi, h_lo = jdc.pack_hashes(jdc.splitmix64(q))
    parts = cache.parts_for(topic_of[q]).astype(np.int32)
    pad = np.zeros(BATCH, bool)
    pad[5::17] = True
    h_hi[pad] = h_lo[pad] = 0xFFFFFFFF
    parts[pad] = cache.k
    admit = rng.random(BATCH) < 0.8
    base = (1 << 31) - 3 + seed
    epochs = np.full(BATCH, base + 2, np.uint32)
    min_epoch = (base + rng.integers(-3, 3, size=BATCH)).astype(np.uint32)
    if seed % 3 == 0:  # freshness off
        epochs[:] = 0
        min_epoch[:] = 0
    return h_hi, h_lo, parts, _backend(q), admit, epochs, min_epoch


_JIT = {}


def _jax_commit(jc, state, engine, batch):
    if JAX_ENGINE[engine] == "host":
        return jc.commit_host(state, *batch)
    key = id(jc)
    if key not in _JIT:
        _JIT[key] = jax.jit(jc.commit_vectorized)
    out = _JIT[key]({k: jnp.asarray(v) for k, v in state.items()},
                    *(jnp.asarray(x) for x in batch))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_commit(tc, state, engine, batch):
    if engine == "host":
        return tc.commit_host(state, *batch)
    if engine == "oracle":
        return tc.commit(state, *batch)
    h_hi, h_lo, parts, vals, admit, eps, minep = batch
    t = tdc.to_device_words
    return tc.commit_vectorized(
        state, t(h_hi, "cpu"), t(h_lo, "cpu"), torch.from_numpy(parts),
        torch.from_numpy(vals), torch.from_numpy(admit), t(eps, "cpu"), t(minep, "cpu"),
    )


def _same(jstate, tstate, what=""):
    mine = tdc.state_to_numpy(tstate)
    for k, v in mine.items():
        want = np.asarray(jstate[k])
        assert want.dtype == v.dtype and np.array_equal(want, v), f"{what}: {k}"


def _chain(engine, n=7):
    """Run the same chain through both packages' ``engine``; returns the
    caches and the final states (JAX: numpy arrays)."""
    jc, tc = _caches()
    js = {k: np.asarray(v) for k, v in jc.init_state.items()}
    ts = {k: v.clone() for k, v in tc.init_state.items()}
    for i in range(n):
        batch = _batch(jc, i, deep=(i == 3))
        js = _jax_commit(jc, js, engine, batch)
        ts = _port_commit(tc, ts, engine, batch)
        _same(js, ts, f"{engine} batch {i}")
    return jc, tc, js, ts


@pytest.mark.parametrize("engine", ENGINES)
def test_commit_engines_match_jax_state_for_state(engine):
    _, _, js, ts = _chain(engine)
    assert (tdc.state_to_numpy(ts)["ks"][:, :W] != 0).sum() > 60
    if engine == "oracle":
        return
    # every engine lands the oracle's state
    _, _, _, oracle = _chain("oracle")
    _same(tdc.state_to_numpy(oracle), ts, f"{engine} vs the oracle")


def test_host_serving_ops_match_jax_and_leave_a_shared_state_alone():
    jc, tc = _caches()
    js = {k: np.asarray(v) for k, v in jc.init_state.items()}
    ts = {k: v.clone() for k, v in tc.init_state.items()}
    for i in range(5):
        h_hi, h_lo, parts, vals, admit, eps, minep = _batch(jc, i, deep=(i == 2))
        before = tdc.state_to_numpy(ts)
        jout = jc.probe_and_commit_host(js, h_hi, h_lo, parts, admit, eps, minep)
        tout = tc.probe_and_commit_host(ts, h_hi, h_lo, parts, admit, eps, minep)
        after = tdc.state_to_numpy(ts)  # inplace=False: the input is untouched
        assert all(np.array_equal(before[k], after[k]) for k in before)
        for a, b in zip(jout[:4] + jout[5][:2], tout[:4] + tout[5][:2]):
            assert np.array_equal(np.asarray(a), b)
        set_idx, wrote, way = jout[5]
        # the plan's way is the slot of a request that wrote; elsewhere it
        # is unspecified (past depth 64 the reference's host engine hands
        # the batch to its sequential loop, which fills it in)
        assert np.array_equal(np.asarray(way)[wrote], tout[5][2][wrote])
        js = jc.fill_values_host(jout[4], set_idx, wrote, way, vals)
        ts = tc.fill_values_host(tout[4], set_idx, wrote, way, vals, inplace=True)
        _same(js, ts, f"batch {i}")
    assert js["clock"] == 5 * BATCH


def _warm(seed=0, n=8):
    """A warm state: a chain through the JAX host engine."""
    jc, _ = _caches()
    js = {k: np.asarray(v) for k, v in jc.init_state.items()}
    for i in range(n):
        js = jc.commit_host(js, *_batch(jc, seed + i, deep=(i == 4)))
    return js


#: tracked popularity that grows topic 0 (one set), shrinks topic 2 from 15
#: sets to 1, or gives topic 3 nothing
POPULARITY = {
    "grow": {0: 50.0, 1: 10.0, 2: 10.0, 3: 10.0, 4: 10.0},
    "shrink": {0: 5.0, 1: 30.0, 2: 1.0, 3: 20.0, 4: 20.0},
    "zero": {0: 5.0, 1: 30.0, 2: 20.0, 4: 20.0},
}


@pytest.mark.parametrize("bucket", [False, True], ids=["exact", "bucketed"])
@pytest.mark.parametrize("case", sorted(POPULARITY))
@pytest.mark.parametrize("engine", ENGINES)
def test_repartition_matches_jax(engine, case, bucket):
    js = _warm()
    jc, tc = _caches()
    pop = POPULARITY[case]
    jcfg, tcfg = jc.cfg.rebalanced(pop), tc.cfg.rebalanced(pop)
    assert jcfg.to_json() == tcfg.to_json() and jcfg.topic_budget == tcfg.topic_budget
    ts = tdc.state_from_numpy(js, "cpu")
    pre = tdc.state_to_numpy(ts)
    jb, tb = (JBucket(), TBucket()) if bucket else (None, None)
    jnew, jstate = jc.repartition(js, jcfg, engine=JAX_ENGINE[engine], bucket=jb)
    tnew, tstate = tc.repartition(ts, tcfg, engine=engine, bucket=tb)
    assert np.array_equal(jnew.part_sets, tnew.part_sets)
    assert np.array_equal(jnew.part_offset, tnew.part_offset)
    _same({k: np.asarray(v) for k, v in jstate.items()}, tstate, "migrated")
    assert all(np.array_equal(pre[k], v) for k, v in tdc.state_to_numpy(ts).items())
    if case == "zero":
        assert tnew.part_sets[tnew.part_of_topic[3]] == 0
    if case == "shrink":
        assert tnew.part_sets[tnew.part_of_topic[2]] == 1
    # serving after the migration routes alike (topic 3's requests to the
    # dynamic partition when it has no sets)
    jstate = {k: np.asarray(v) for k, v in jstate.items()}
    batch = _batch(jnew, 20)
    topic_of, _ = _universe()
    assert np.array_equal(jnew.parts_for(topic_of), tnew.parts_for(topic_of))
    _same(jnew.commit_host(jstate, *batch), tnew.commit_host(tstate, *batch), "after")


def test_extract_live_and_bulk_insert_match_jax():
    js = _warm(seed=3)
    jc, tc = _caches()
    ts = tdc.state_from_numpy(js, "cpu")
    got_j, got_t = jc.extract_live(js), tc.extract_live(ts)
    for a, b in zip(got_j, got_t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    stamps = got_t[4]
    # stamps are unique among live entries, so any sort gives this order
    assert len(np.unique(stamps)) == len(stamps) and np.all(np.diff(stamps) > 0)
    assert set(got_t[1]) <= set(TOPIC_ENTRIES) | {tdc.DYNAMIC}
    h64, topics, vals, eps, _ = got_t
    for engine in ENGINES:
        for jb, tb in ((None, None), (JBucket(mode="explicit", sizes=(300,)),
                                      TBucket(mode="explicit", sizes=(300,)))):
            jnew = dict(jc.init_state)
            jnew = jc.bulk_insert(jnew, h64, topics, vals, epochs=eps,
                                  engine=JAX_ENGINE[engine], bucket=jb)
            tnew = {k: v.clone() for k, v in tc.init_state.items()}
            tnew = tc.bulk_insert(tnew, h64, topics, vals, epochs=eps, engine=engine, bucket=tb)
            _same({k: np.asarray(v) for k, v in jnew.items()}, tnew, engine)
            want_clock = 300 if tb is not None else len(h64)
            assert int(tnew["clock"]) == want_clock


def test_invalidate_keys_matches_jax():
    js = _warm(seed=5)
    jc, tc = _caches()
    ts = tdc.state_from_numpy(js, "cpu")
    topic_of, static_q = _universe()
    q = np.concatenate([np.arange(0, N_Q, 3), np.arange(0, N_Q, 3)[:20], [-1]])
    h_hi, h_lo = jdc.pack_hashes(jdc.splitmix64(q))
    parts = jc.parts_for(np.where(q >= 0, topic_of[np.maximum(q, 0)], -1))
    jout, jn = jc.invalidate_keys(js, h_hi, h_lo, parts)
    tout, tn = tc.invalidate_keys(ts, h_hi, h_lo, parts)
    assert jn == tn > 0
    _same({k: np.asarray(v) for k, v in jout.items()}, tout, "invalidated")
    # the input state is untouched, and a second pass finds nothing
    _same(js, ts, "input")
    assert tc.invalidate_keys(tout, h_hi, h_lo, parts)[1] == 0


def test_configs_and_unpack_state_match_jax():
    jc, tc = _caches()
    pop = {0: 3.0, 2: 1.5}
    assert jc.cfg.rebalanced(pop).to_json() == tc.cfg.rebalanced(pop).to_json()
    assert tc.cfg.pad_key == jc.cfg.pad_key == -1
    js = _warm(seed=1)
    ts = tdc.state_from_numpy(js, "cpu")
    for a, b in zip(jdc.unpack_state(js), tdc.unpack_state(ts)):
        assert np.array_equal(np.asarray(a).view(np.int32), b.numpy())
