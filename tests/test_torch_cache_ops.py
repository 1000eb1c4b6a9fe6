"""Conformance of the port's cache ops with the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX ops and the port's
``repro_torch`` counterparts (which run their kernels' plain PyTorch
versions on the CPU).  Integer state must agree bit for bit: tolerance 0
on every output.  The references are

* the JAX jnp path (``use_kernel=False``),
* the Pallas kernels in interpret mode (``use_kernel=True,
  interpret=True``) on a few cases (each new shape costs seconds),
* the sequential numpy oracles ``probe_and_commit_ref`` and
  ``serve_fused_ref``.

Cases: a ragged final kernel tile, an all-pad batch, an all-static-hit
batch, duplicate keys crowded into few sets, a fill plan with slot
collisions, freshness off, and expiry with epochs below and above 2**31;
deep segments (one set taking 1 to 355 requests of a batch, and a whole
batch in one set) at W = 4, 8, 16 and 32, with pads, static hits,
non-admitted misses and stale hits inside the run.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import cache_ops as jops  # noqa: E402
from repro.serving import device_cache as jdc  # noqa: E402
from repro_torch.kernels import cache_ops as tops  # noqa: E402
from repro_torch.serving import device_cache as tdc  # noqa: E402


def t32(x):
    """numpy uint32/int32 words -> int32 torch tensor with the same bits."""
    return tdc.to_device_words(np.asarray(x), "cpu")


def u32(t):
    return t.numpy().view(np.uint32)


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def make_case(kind, seed=0, s=24, w=4, v=3, b=120):
    rng = np.random.default_rng(seed)
    n_keys = 40
    pool_hi = _words(rng, n_keys)
    pool_lo = _words(rng, n_keys)
    slot_key = rng.integers(0, n_keys, size=(s, w))
    key_hi, key_lo = pool_hi[slot_key], pool_lo[slot_key]
    key_hi[rng.random((s, w)) < 0.15] = 0  # empty slots
    stamp = rng.integers(-100, 100, size=(s, w)).astype(np.int32)
    base = {"fresh_hi": 2**31 + 5, "fresh_lo": 1000}.get(kind, 0)
    epoch = (base + rng.integers(0, 10, size=(s, w))).astype(np.uint32)
    if base == 0:
        epoch[:] = 0
    value = rng.integers(0, 1 << 30, size=(s, w, v)).astype(np.int32)
    n_sets = 3 if kind == "dups" else s
    set_idx = rng.integers(0, n_sets, size=b).astype(np.int32)
    req = rng.integers(0, n_keys, size=b)
    if kind == "dups":
        req = rng.integers(0, 4, size=b)
    h_hi, h_lo = pool_hi[req], pool_lo[req]
    # a resident key probed in its own set: hits exist in every case
    res = rng.random(b) < 0.4
    way = rng.integers(0, w, size=b)
    h_hi[res] = key_hi[set_idx[res], way[res]]
    h_lo[res] = key_lo[set_idx[res], way[res]]
    h_hi[res & (h_hi == 0)] = 7  # an empty slot is not a key
    pad = np.zeros(b, bool)
    pad[::11] = True
    if kind == "all_pad":
        pad[:] = True
    h_hi[pad] = 0xFFFFFFFF
    h_lo[pad] = 0xFFFFFFFF
    admit = rng.random(b) < 0.8
    static_hit = rng.random(b) < 0.15
    if kind == "all_static":
        static_hit[:] = True
    if base:
        epochs = np.full(b, base + 12, np.uint32)
        min_epoch = (base + rng.integers(-2, 12, size=b)).astype(np.uint32)
        min_epoch[::7] = 0xFFFFFFFF  # the saturated floor
    else:
        epochs = np.zeros(b, np.uint32)
        min_epoch = np.zeros(b, np.uint32)
    f_set = rng.integers(0, s, size=b).astype(np.int32)
    f_set[: b // 3] = f_set[b // 3 : 2 * (b // 3)]  # slot collisions
    f_way = rng.integers(0, w, size=b).astype(np.int32)
    f_way[: b // 3] = f_way[b // 3 : 2 * (b // 3)]
    f_wrote = rng.random(b) < 0.6
    f_values = rng.integers(0, 1 << 30, size=(b, v)).astype(np.int32)
    return dict(
        key_hi=key_hi, key_lo=key_lo, stamp=stamp, epoch=epoch, value=value,
        h_hi=h_hi, h_lo=h_lo, set_idx=set_idx, admit=admit, static_hit=static_hit,
        clock=np.int32(1 << 30), epochs=epochs, min_epoch=min_epoch,
        f_set=f_set, f_way=f_way, f_wrote=f_wrote, f_values=f_values,
    )


KINDS = ["plain", "all_pad", "all_static", "dups", "fresh_lo", "fresh_hi"]


def _ks(c):
    return jops.pack_words(c["key_hi"], c["key_lo"], c["stamp"], c["epoch"])


def _jax_args(c):
    return (
        jnp.asarray(_ks(c)), jnp.asarray(c["h_hi"]), jnp.asarray(c["h_lo"]),
        jnp.asarray(c["set_idx"]), jnp.asarray(c["admit"]),
        jnp.asarray(c["static_hit"]), jnp.asarray(c["clock"]),
    )


def _port_args(c):
    return (
        t32(_ks(c)), t32(c["h_hi"]), t32(c["h_lo"]), t32(c["set_idx"]),
        torch.from_numpy(c["admit"]), torch.from_numpy(c["static_hit"]),
        torch.tensor(c["clock"]),
    )


def _jax_fill(c):
    return dict(
        f_set_idx=jnp.asarray(c["f_set"]), f_wrote=jnp.asarray(c["f_wrote"]),
        f_way=jnp.asarray(c["f_way"]), f_values=jnp.asarray(c["f_values"]),
    )


def _port_fill(c):
    return dict(
        f_set_idx=t32(c["f_set"]), f_wrote=torch.from_numpy(c["f_wrote"]),
        f_way=t32(c["f_way"]), f_values=t32(c["f_values"]),
    )


def _assert_same(jax_out, port_out):
    for k, want in jax_out.items():
        got = port_out[k]
        want = np.asarray(want)
        got = u32(got) if want.dtype == np.uint32 else got.numpy()
        assert want.shape == got.shape, k
        assert np.array_equal(want.astype(np.int64), got.astype(np.int64)), k


def _port_probe_and_commit(c):
    return tops.probe_and_commit_op(
        *_port_args(c), epochs=t32(c["epochs"]), min_epoch=t32(c["min_epoch"])
    )


def _port_serve(c, plan=True):
    ks, *rest = _port_args(c)
    return tops.serve_fused_op(
        ks, torch.from_numpy(c["value"].copy()), *rest,
        **(_port_fill(c) if plan else {}),
        epochs=t32(c["epochs"]), min_epoch=t32(c["min_epoch"]),
    )


@pytest.mark.parametrize("kind", KINDS)
def test_probe_and_commit_matches_jnp_and_numpy_oracle(kind):
    c = make_case(kind)
    got = _port_probe_and_commit(c)
    want = jops.probe_and_commit_op(
        *_jax_args(c), epochs=jnp.asarray(c["epochs"]),
        min_epoch=jnp.asarray(c["min_epoch"]), use_kernel=False,
    )
    _assert_same(want, got)
    oracle = jops.probe_and_commit_ref(
        c["key_hi"], c["key_lo"], c["stamp"], c["h_hi"], c["h_lo"], c["set_idx"],
        c["admit"], c["static_hit"], int(c["clock"]), epoch=c["epoch"],
        epochs=c["epochs"], min_epoch=c["min_epoch"],
    )
    hi, lo, st = tops.unpack_words(got["ks"])
    ep = tops.unpack_epoch(got["ks"])
    _assert_same(
        {k: oracle[k] for k in ("pre_hit", "pre_way", "pre_stale", "pre_epoch", "wrote", "way")},
        got,
    )
    assert np.array_equal(oracle["key_hi"], u32(hi.contiguous()))
    assert np.array_equal(oracle["key_lo"], u32(lo.contiguous()))
    assert np.array_equal(oracle["stamp"], st.contiguous().numpy())
    assert np.array_equal(oracle["epoch"], u32(ep.contiguous()))


@pytest.mark.parametrize("kind", KINDS)
def test_serve_fused_matches_jnp_and_numpy_oracle(kind):
    c = make_case(kind, seed=1)
    got = _port_serve(c)
    want = jops.serve_fused_op(
        *_jax_args(c)[:1], jnp.asarray(c["value"]), *_jax_args(c)[1:],
        **_jax_fill(c), epochs=jnp.asarray(c["epochs"]),
        min_epoch=jnp.asarray(c["min_epoch"]), use_kernel=False,
    )
    _assert_same(want, got)
    oracle = jops.serve_fused_ref(
        c["key_hi"], c["key_lo"], c["stamp"], c["value"], c["h_hi"], c["h_lo"],
        c["set_idx"], c["admit"], c["static_hit"], int(c["clock"]),
        epoch=c["epoch"], epochs=c["epochs"], min_epoch=c["min_epoch"],
        f_set_idx=c["f_set"], f_wrote=c["f_wrote"], f_way=c["f_way"],
        f_values=c["f_values"],
    )
    assert np.array_equal(oracle["value"], got["value"].numpy())
    assert np.array_equal(oracle["values"], got["values"].numpy())
    _assert_same(
        {k: oracle[k] for k in ("pre_hit", "pre_way", "pre_stale", "pre_epoch", "wrote", "way")},
        got,
    )


def make_deep_case(depth, w, seed=0, s=48, v=3, b=400, static_share=0.2):
    """A batch of ``b`` with ``depth`` requests in one set (``c["hot"]``),
    in arrival order among the rest: Zipf draws over the set's
    resident keys and three times as many new ones (in-batch re-inserts and
    evictions), with pads, static hits, non-admitted misses, stale hits and
    epochs and floors on both sides of 2**31 inside the run
    (``static_share`` of it static hits).  The other requests spread over
    the other sets."""
    c = make_case("fresh_hi", seed=seed, s=s, w=w, v=v, b=b)
    rng = np.random.default_rng(seed + 100)
    e0 = 2**31 - 3
    c["epoch"] = (e0 + rng.integers(-4, 5, size=(s, w))).astype(np.uint32)
    c["epochs"] = (e0 + rng.integers(-3, 8, size=b)).astype(np.uint32)
    c["min_epoch"] = (e0 + rng.integers(-5, 6, size=b)).astype(np.uint32)
    c["min_epoch"][::17] = 0xFFFFFFFF  # the saturated floor
    run = np.sort(rng.choice(b, depth, replace=False))
    hot = int(rng.integers(0, s))
    c["set_idx"] = np.where(c["set_idx"] == hot, (hot + 1) % s, c["set_idx"]).astype(np.int32)
    c["set_idx"][run] = hot
    pool_hi = np.concatenate([c["key_hi"][hot], _words(rng, 3 * w)])
    pool_lo = np.concatenate([c["key_lo"][hot], _words(rng, 3 * w)])
    pool_hi[pool_hi == 0] = 9  # an empty way is not a key
    pick = np.minimum(rng.zipf(1.3, size=depth) - 1, 4 * w - 1)
    c["h_hi"][run], c["h_lo"][run] = pool_hi[pick], pool_lo[pick]
    c["h_hi"][run[3::7]] = c["h_lo"][run[3::7]] = 0xFFFFFFFF  # pads
    c["static_hit"][run] = rng.random(depth) < static_share
    c["admit"][run] = rng.random(depth) < 0.7
    c["hot"] = hot
    return c


#: segment depths around the 32-request chunks the CUDA kernels walk
DEEP = [1, 2, 3, 31, 32, 33, 64, 65, 355]


@pytest.mark.parametrize(
    "depth,w",
    [(d, 8) for d in DEEP] + [(d, w) for w in (4, 16, 32) for d in (3, 33, 355)],
)
def test_deep_segments_match_jnp_and_numpy_oracle(depth, w):
    c = make_deep_case(depth, w, seed=depth + w)
    run = c["set_idx"] == c["hot"]
    assert run.sum() == depth
    pads = (c["h_hi"] == 0xFFFFFFFF) & (c["h_lo"] == 0xFFFFFFFF)
    got = _port_probe_and_commit(c)
    if depth >= 31:  # the run holds every kind of request
        assert (pads & run).any() and (c["static_hit"] & run & ~pads).any()
        assert (~c["admit"] & ~got["pre_hit"].numpy() & run & ~pads).any()
        assert (got["pre_stale"].numpy() & run).any() and got["wrote"].numpy()[run].any()
    want = jops.probe_and_commit_op(
        *_jax_args(c), epochs=jnp.asarray(c["epochs"]),
        min_epoch=jnp.asarray(c["min_epoch"]), use_kernel=False,
    )
    _assert_same(want, got)
    oracle = jops.serve_fused_ref(
        c["key_hi"], c["key_lo"], c["stamp"], c["value"], c["h_hi"], c["h_lo"],
        c["set_idx"], c["admit"], c["static_hit"], int(c["clock"]),
        epoch=c["epoch"], epochs=c["epochs"], min_epoch=c["min_epoch"],
        f_set_idx=c["f_set"], f_wrote=c["f_wrote"], f_way=c["f_way"],
        f_values=c["f_values"],
    )
    got = _port_serve(c)
    assert np.array_equal(oracle["value"], got["value"].numpy())
    assert np.array_equal(oracle["values"], got["values"].numpy())
    _assert_same(
        {k: oracle[k] for k in ("pre_hit", "pre_way", "pre_stale", "pre_epoch", "wrote", "way")},
        got,
    )
    hi, lo, st = tops.unpack_words(got["ks"])
    assert np.array_equal(oracle["key_hi"], u32(hi.contiguous()))
    assert np.array_equal(oracle["stamp"], st.contiguous().numpy())
    assert np.array_equal(oracle["epoch"], u32(tops.unpack_epoch(got["ks"]).contiguous()))


@pytest.mark.parametrize("depth,share", [(80, 1.0), (355, 0.6)])
def test_runs_of_static_hits_match_jnp(depth, share):
    # the serving stream's deepest segment is its head query, a static hit
    c = make_deep_case(depth, 8, seed=depth, static_share=share)
    want = jops.serve_fused_op(
        *_jax_args(c)[:1], jnp.asarray(c["value"]), *_jax_args(c)[1:],
        **_jax_fill(c), epochs=jnp.asarray(c["epochs"]),
        min_epoch=jnp.asarray(c["min_epoch"]), use_kernel=False,
    )
    _assert_same(want, _port_serve(c))


@pytest.mark.parametrize("w", [4, 32])
def test_whole_batch_in_one_set_matches_jnp_and_numpy_oracle(w):
    # a topic partition of one set: every request of the batch in it
    c = make_deep_case(300, w, seed=w, s=1, b=300)
    assert (c["set_idx"] == 0).all()
    got = _port_serve(c)
    want = jops.serve_fused_op(
        *_jax_args(c)[:1], jnp.asarray(c["value"]), *_jax_args(c)[1:],
        **_jax_fill(c), epochs=jnp.asarray(c["epochs"]),
        min_epoch=jnp.asarray(c["min_epoch"]), use_kernel=False,
    )
    _assert_same(want, got)
    oracle = jops.probe_and_commit_ref(
        c["key_hi"], c["key_lo"], c["stamp"], c["h_hi"], c["h_lo"], c["set_idx"],
        c["admit"], c["static_hit"], int(c["clock"]), epoch=c["epoch"],
        epochs=c["epochs"], min_epoch=c["min_epoch"],
    )
    _assert_same(
        {k: oracle[k] for k in ("pre_hit", "pre_way", "pre_stale", "pre_epoch", "wrote", "way")},
        _port_probe_and_commit(c),
    )


@pytest.mark.parametrize("kind", ["fresh_hi", "dups"])
def test_ops_match_the_pallas_kernels_in_interpret_mode(kind):
    # b = 300 with bm = 256: two grid steps, the second a ragged tile
    c = make_case(kind, seed=2, b=300)
    want = jops.probe_and_commit_op(
        *_jax_args(c), epochs=jnp.asarray(c["epochs"]),
        min_epoch=jnp.asarray(c["min_epoch"]), use_kernel=True, interpret=True,
    )
    _assert_same(want, _port_probe_and_commit(c))
    want = jops.serve_fused_op(
        *_jax_args(c)[:1], jnp.asarray(c["value"]), *_jax_args(c)[1:],
        **_jax_fill(c), epochs=jnp.asarray(c["epochs"]),
        min_epoch=jnp.asarray(c["min_epoch"]), use_kernel=True, interpret=True,
    )
    _assert_same(want, _port_serve(c))


def test_serve_without_a_fill_plan_and_empty_batch():
    c = make_case("fresh_lo", seed=3)
    want = jops.serve_fused_op(
        *_jax_args(c)[:1], jnp.asarray(c["value"]), *_jax_args(c)[1:],
        epochs=jnp.asarray(c["epochs"]), min_epoch=jnp.asarray(c["min_epoch"]),
    )
    _assert_same(want, _port_serve(c, plan=False))
    c = make_case("plain", seed=3, b=0)
    got = _port_serve(c)
    assert got["values"].shape == (0, 3)
    assert np.array_equal(u32(got["ks"]), _ks(c))


def test_pad_key_is_inert():
    c = make_case("all_pad", seed=4)
    got = _port_probe_and_commit(c)
    assert np.array_equal(u32(got["ks"]), _ks(c))  # nothing moved
    assert not got["pre_hit"].any() and not got["wrote"].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_segments_matches_jax(seed):
    rng = np.random.default_rng(seed)
    set_idx = rng.integers(0, 9, size=70).astype(np.int32)
    want = jops.plan_segments(jnp.asarray(set_idx))
    got = tops.plan_segments(torch.from_numpy(set_idx))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_fill_winner_slots_matches_jax():
    c = make_case("plain", seed=5)
    s, w = c["key_hi"].shape
    f_set = c["f_set"].copy()
    f_set[:5] = s + 3  # out of bounds: dropped
    want = jops.fill_winner_slots(
        s * w, w, jnp.asarray(f_set), jnp.asarray(c["f_wrote"]), jnp.asarray(c["f_way"])
    )
    got = tops.fill_winner_slots(
        s * w, w, t32(f_set), torch.from_numpy(c["f_wrote"]), t32(c["f_way"])
    )
    assert np.array_equal(np.asarray(want), got.numpy())


def test_pack_unpack_match_jax():
    c = make_case("fresh_hi", seed=6)
    ks = tops.pack_words(t32(c["key_hi"]), t32(c["key_lo"]), t32(c["stamp"]), t32(c["epoch"]))
    assert np.array_equal(u32(ks), _ks(c))
    hi, lo, st = tops.unpack_words(ks)
    jhi, jlo, jst = jops.unpack_words(_ks(c))
    assert np.array_equal(u32(hi.contiguous()), jhi)
    assert np.array_equal(u32(lo.contiguous()), jlo)
    assert np.array_equal(st.contiguous().numpy(), jst)
    assert np.array_equal(u32(tops.unpack_epoch(ks).contiguous()), jops.unpack_epoch(_ks(c)))
    no_ep = tops.pack_words(t32(c["key_hi"]), t32(c["key_lo"]), t32(c["stamp"]))
    assert np.array_equal(u32(no_ep), jops.pack_words(c["key_hi"], c["key_lo"], c["stamp"]))


def test_host_hashing_matches_jax():
    q = np.concatenate([np.arange(-1, 2000), [2**62, 2**63 - 1]]).astype(np.int64)
    h = tdc.splitmix64(q)
    assert np.array_equal(h, jdc.splitmix64(q))
    assert h[0] == tdc.PAD_H64 and (h[1:] != 0).all() and (h[1:] != tdc.PAD_H64).all()
    for a, b in zip(tdc.pack_hashes(h), jdc.pack_hashes(h)):
        assert np.array_equal(a, b)
    hi, lo = tdc.pack_hashes(h[:10])
    got = tdc.pad_batch(hi, lo, np.arange(10), 3, 16, values=np.ones((10, 2)), admit=np.ones(10, bool))
    want = jdc.pad_batch(hi, lo, np.arange(10), 3, 16, values=np.ones((10, 2)), admit=np.ones(10, bool))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def _caches(seed=7):
    """A JAX cache and its port twin with a populated state carried over."""
    rng = np.random.default_rng(seed)
    cfg_args = dict(n=512, f_s=0.2, f_t=0.5, topic_distinct={0: 5, 3: 9, 4: 2}, ways=4, value_dim=3)
    static_q = rng.integers(0, 10_000, size=80)
    sv = rng.integers(0, 99, size=(80, 3)).astype(np.int32)
    jc = jdc.STDDeviceCache(jdc.DeviceCacheConfig.build(**cfg_args),
                            static_hashes=jdc.splitmix64(static_q), static_values=sv)
    tc = tdc.STDDeviceCache(tdc.DeviceCacheConfig.build(**cfg_args),
                            static_hashes=tdc.splitmix64(static_q), static_values=sv, device="cpu")
    state = {k: np.asarray(v) for k, v in jc.init_state.items()}
    s, w4 = state["ks"].shape
    ks = _words(rng, (s, w4))
    ks[:, : w4 // 4][rng.random((s, w4 // 4)) < 0.3] = 0
    state["ks"] = ks
    state["value"] = rng.integers(0, 99, size=state["value"].shape).astype(np.int32)
    q = np.concatenate([static_q[:30], rng.integers(0, 10_000, size=60), [-1, -1]])
    h_hi, h_lo = jdc.pack_hashes(jdc.splitmix64(q))
    # route some requests onto resident keys of their own set
    part = tc.parts_for(rng.integers(-1, 6, size=len(q)))
    return jc, tc, state, h_hi, h_lo, part, static_q


def test_static_lookup_set_index_and_probe_match_jax():
    jc, tc, state, h_hi, h_lo, part, static_q = _caches()
    assert np.array_equal(jc.parts_for(np.arange(-2, 8)), tc.parts_for(np.arange(-2, 8)))
    tstate = tdc.state_from_numpy(state, "cpu")
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jhit, jidx = jc.static_lookup(jstate, jnp.asarray(h_hi), jnp.asarray(h_lo))
    thit, tidx = tc.static_lookup(tstate, t32(h_hi), t32(h_lo))
    assert np.array_equal(np.asarray(jhit), thit.numpy())
    assert np.array_equal(np.asarray(jidx), tidx.numpy())
    assert thit.numpy()[:30].all()
    assert (np.asarray(state["static_hi"]) >= 2**31).any()  # the unsigned order matters
    jset = jc._set_index(jnp.asarray(h_lo), jnp.asarray(part))
    tset = tc._set_index(t32(h_lo), torch.from_numpy(part))
    assert np.array_equal(np.asarray(jset), tset.numpy())
    minep = np.random.default_rng(0).integers(0, 2**32, size=len(h_hi), dtype=np.uint64).astype(np.uint32)
    want = jc.probe(jstate, jnp.asarray(h_hi), jnp.asarray(h_lo), jnp.asarray(part), jnp.asarray(minep))
    got = tc.probe(tstate, t32(h_hi), t32(h_lo), torch.from_numpy(part), t32(minep))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_state_carries_across_bit_for_bit_and_config_json_interoperates():
    jc, tc, state, *_ = _caches(seed=8)
    back = tdc.state_to_numpy(tdc.state_from_numpy(state, "cpu"))
    for k, v in state.items():
        assert back[k].dtype == np.asarray(v).dtype and np.array_equal(back[k], v), k
    assert tdc.DeviceCacheConfig.from_json(jc.cfg.to_json()) == tc.cfg
    assert jdc.DeviceCacheConfig.from_json(tc.cfg.to_json()) == jc.cfg
    assert json.loads(tc.cfg.to_json()) == json.loads(jc.cfg.to_json())
    with pytest.raises(TypeError):
        tdc.state_from_numpy(dict(state, ks=state["ks"].astype(np.int64)), "cpu")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = tdc.DeviceCacheConfig.build(64, 0.1, 0.5, {0: 3})
    with pytest.raises(RuntimeError):
        tdc.STDDeviceCache(cfg)  # default device is "cuda"
    with pytest.raises(RuntimeError):
        tdc.state_from_numpy({}, "cuda")


@pytest.mark.parametrize("kind", KINDS)
def test_numpy_oracles_equal_the_references(kind):
    """``probe_and_commit_ref`` and ``serve_fused_ref``, the port's copies
    of the JAX package's numpy oracles, give the reference's outputs array
    for array (tolerance 0), with and without a fill plan and epochs."""
    c = make_case(kind, seed=7)
    args = (c["key_hi"], c["key_lo"], c["stamp"], c["h_hi"], c["h_lo"], c["set_idx"],
            c["admit"], c["static_hit"], int(c["clock"]))
    fresh = dict(epoch=c["epoch"], epochs=c["epochs"], min_epoch=c["min_epoch"])
    fill = dict(f_set_idx=c["f_set"], f_wrote=c["f_wrote"], f_way=c["f_way"],
                f_values=c["f_values"])
    pairs = [
        (jops.probe_and_commit_ref(*args), tops.probe_and_commit_ref(*args)),
        (jops.probe_and_commit_ref(*args, **fresh), tops.probe_and_commit_ref(*args, **fresh)),
        (jops.serve_fused_ref(*args[:3], c["value"], *args[3:], **fresh, **fill),
         tops.serve_fused_ref(*args[:3], c["value"], *args[3:], **fresh, **fill)),
        (jops.serve_fused_ref(*args[:3], c["value"], *args[3:]),
         tops.serve_fused_ref(*args[:3], c["value"], *args[3:])),
    ]
    for want, got in pairs:
        assert want.keys() == got.keys()
        for k, w in want.items():
            assert w.dtype == got[k].dtype and np.array_equal(w, got[k]), k


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_seg_id", [True, False])
def test_resolve_conflicts_equals_the_references(kind, with_seg_id):
    """The vectorised rounds loop on one planned batch: resolved rows and
    the write plan equal the JAX ``resolve_conflicts``'s, with ``seg_id``
    given and recomputed from ``leader``/``seg_len``."""
    c = make_case(kind, seed=8)
    if kind == "dups":
        c["set_idx"][:40] = 1  # one deep segment
    order, seg_id, leader, seg_len, seg_set = (np.array(x) for x in jops.plan_segments(
        jnp.asarray(c["set_idx"])))
    rows = np.minimum(seg_set, c["key_hi"].shape[0] - 1)
    fields = [c["key_hi"][rows], c["key_lo"][rows], c["stamp"][rows], c["epoch"][rows]]
    sorted_ = [c["h_hi"][order], c["h_lo"][order], order.astype(np.int32), c["admit"][order],
               c["static_hit"][order], c["epochs"][order], c["min_epoch"][order]]
    extra = lambda sid: {"seg_id": sid} if with_seg_id else {}  # noqa: E731
    want = jops.resolve_conflicts(
        *(jnp.asarray(x) for x in fields + sorted_), jnp.asarray(leader), jnp.asarray(seg_len),
        jnp.asarray(c["clock"]), **extra(jnp.asarray(seg_id)))
    got = tops.resolve_conflicts(
        *(t32(x) for x in fields), *(t32(x) for x in sorted_[:3]),
        *(torch.from_numpy(x) for x in sorted_[3:5]), *(t32(x) for x in sorted_[5:]),
        torch.from_numpy(leader), torch.from_numpy(seg_len), torch.tensor(c["clock"]),
        **extra(torch.from_numpy(seg_id)))
    assert int(seg_len.max()) > 1
    for name, w, g in zip(("hi", "lo", "stamp", "epoch", "wrote", "way"), want, got):
        w = np.asarray(w)
        g = u32(g) if w.dtype == np.uint32 else g.numpy()
        assert w.shape == g.shape and np.array_equal(w.astype(np.int64), g.astype(np.int64)), name
