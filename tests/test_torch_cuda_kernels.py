"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test decides inside itself whether a card is present
and skips without one, so every worker collects the same tests.  Run on a
machine with an H100 (the kernels build for sm_90a):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Every output of the cache kernels -- the packed state, the value table,
the per-request probe outputs and the write plan -- must be equal
(tolerance 0: integer state), also on migration-shaped batches (a
partition shrunk 8x and 64x behind a tail of pads in one set); at a pad
tail of ~2**16 and a batch of 2**18, where the plain version (O(depth x
B)) would take minutes, ``bulk_insert`` through the kernel is held to the
numpy host engine instead, as is a card broker's live ``rebalance()``.
The topic-score kernel is held to the
tolerances of ``tests/test_kernels.py``: scores rtol 1e-4; ``top`` exact,
except where the plain version's top two scores lie within 1e-4 relative
(the two sum in different orders); the confidence within rtol 1e-4 of the
plain epilogue (softmax) applied to the kernel's own scores, and, on the
sweep shapes of ``tests/test_kernels.py``, of the plain version's.  At V =
4096 the scores reach ~3400, where an f32 ulp is 2.4e-4: two summation
orders differ by ~1e-3 there, and the confidence, a softmax of score
differences, by up to ~1e-3 relative.  The decode-attention kernel is held
to its plain version at 2e-6 in f32 (``tests/test_kernels.py``'s) and, in
bf16, within one bf16 ulp of the plain output (rtol 2**-7) plus 1e-5 of the
largest output: both compute in f32 and differ there only by their
summation orders, so their bf16 roundings differ by at most one ulp, and
near zero by the f32 difference.  A fixed 3e-2 would be the size of the
outputs themselves at S in the thousands.  The embedding-bag kernel must
equal its plain version bit for bit (tolerance 0), in f32 and bf16: both
sum each bag's rows in f32 in slot order and round the same way; only a
NaN (an id past the table) is compared as NaN, since the card's bf16
conversions write different NaN bits.  The table's gradient through the
kernel must equal autograd's through the plain version bit for bit under
deterministic algorithms (the same ``index_add_`` on the same inputs).  This file imports no JAX: the
machine with the card has none.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cache_ops import (  # noqa: E402
    fill_winner_slots,
    plan_segments,
    probe_and_commit_op,
    serve_fused_op,
)
from repro_torch.kernels.cache_ops import kernel as pac_kernel  # noqa: E402
from repro_torch.kernels.cache_ops import ref  # noqa: E402
from repro_torch.kernels.cache_ops import serve_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_op,
    decode_attention_plain,
)
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_op, embedding_bag_plain  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as eb_kernel  # noqa: E402
from repro_torch.kernels.topic_score import kernel as ts_kernel  # noqa: E402
from repro_torch.kernels.topic_score import topic_score_op, topic_score_plain  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Broker,
    BucketSpec,
    DeviceCacheConfig,
    FreshnessSpec,
    RebalanceSpec,
    STDDeviceCache,
    splitmix64,
    state_to_numpy,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, shape):
    return torch.from_numpy(rng.integers(0, 2**32, size=shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


def _case(seed, s, w, v, b, dup_sets=False):
    """A populated state and a batch with hits, duplicates, pads, static
    hits, and epochs/floors on both sides of 2**31."""
    rng = np.random.default_rng(seed)
    keys_hi = _words(rng, (s, w))
    keys_lo = _words(rng, (s, w))
    keys_hi[torch.from_numpy(rng.random((s, w)) < 0.2)] = 0  # empty slots
    stamp = torch.from_numpy(rng.integers(-1000, 1000, size=(s, w)).astype(np.int32))
    epoch = _words(rng, (s, w))
    ks = torch.cat([keys_hi, keys_lo, stamp, epoch], 1).contiguous()
    value = torch.from_numpy(rng.integers(0, 1 << 30, size=(s, w, v)).astype(np.int32))
    n_sets = 3 if dup_sets else s
    set_idx = torch.from_numpy(rng.integers(0, n_sets, size=b).astype(np.int32))
    way = torch.from_numpy(rng.integers(0, w, size=b))
    h_hi = _words(rng, b)
    h_lo = _words(rng, b)
    resident = torch.from_numpy(rng.random(b) < 0.5)
    h_hi[resident] = keys_hi[set_idx[resident].long(), way[resident]]
    h_lo[resident] = keys_lo[set_idx[resident].long(), way[resident]]
    dup = torch.from_numpy(rng.integers(0, b, size=b // 4))
    h_hi[-len(dup):], h_lo[-len(dup):] = h_hi[dup], h_lo[dup]
    set_idx[-len(dup):] = set_idx[dup]
    h_hi[::17] = -1  # the pad key: all-ones words
    h_lo[::17] = -1
    admit = torch.from_numpy(rng.random(b) < 0.8)
    static_hit = torch.from_numpy(rng.random(b) < 0.1)
    epochs = _words(rng, b)
    min_epoch = _words(rng, b)
    f_set = torch.from_numpy(rng.integers(0, s, size=b).astype(np.int32))
    f_set[: b // 2] = f_set[b // 2 : 2 * (b // 2)]  # slot collisions
    f_way = torch.from_numpy(rng.integers(0, w, size=b).astype(np.int32))
    f_wrote = torch.from_numpy(rng.random(b) < 0.6)
    f_vals = torch.from_numpy(rng.integers(0, 1 << 30, size=(b, v)).astype(np.int32))
    return dict(
        ks=ks, value=value, h_hi=h_hi, h_lo=h_lo, set_idx=set_idx, admit=admit,
        static_hit=static_hit, clock=torch.tensor(2**31 - 50, dtype=torch.int32),
        f_set_idx=f_set, f_wrote=f_wrote, f_way=f_way, f_values=f_vals,
        epochs=epochs, min_epoch=min_epoch,
    )


def _to(case, dev):
    return {k: t.clone().to(dev) for k, t in case.items()}


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


SHAPES = [(64, 4, 3, 200, False), (512, 8, 8, 1024, False), (32, 8, 8, 300, True),
          (16, 16, 2, 100, True), (8, 2, 1, 50, True)]


@pytest.mark.parametrize("s,w,v,b,dup_sets", SHAPES)
def test_serve_fused_op_on_card_equals_cpu_plain(cuda, s, w, v, b, dup_sets):
    case = _case(1, s, w, v, b, dup_sets)
    before = serve_kernel.launches
    got = serve_fused_op(**_to(case, cuda))
    torch.cuda.synchronize()
    assert serve_kernel.launches == before + 1
    want = serve_fused_op(**_to(case, "cpu"))
    _assert_equal(got, want)


@pytest.mark.parametrize("s,w,v,b,dup_sets", SHAPES)
def test_probe_and_commit_op_on_card_equals_cpu_plain(cuda, s, w, v, b, dup_sets):
    case = _case(2, s, w, v, b, dup_sets)
    for k in ("value", "f_set_idx", "f_wrote", "f_way", "f_values"):
        del case[k]
    before = pac_kernel.launches
    got = probe_and_commit_op(**_to(case, cuda))
    torch.cuda.synchronize()
    assert pac_kernel.launches == before + 1
    want = probe_and_commit_op(**_to(case, "cpu"))
    _assert_equal(got, want)


def _kernel_args(case, dev):
    c = _to(case, dev)
    s, w, v = c["value"].shape
    order, _, leader, seg_len, seg_set = plan_segments(c["set_idx"])
    f_slot = fill_winner_slots(s * w, w, c["f_set_idx"], c["f_wrote"], c["f_way"])
    common = (order, leader, seg_len, seg_set, c["h_hi"], c["h_lo"], c["admit"],
              c["static_hit"], c["epochs"], c["min_epoch"], c["clock"])
    return c["ks"], c["value"].view(s * w, v), f_slot, c["f_values"], common


def test_kernels_equal_plain_versions_on_the_card(cuda):
    case = _case(3, 256, 8, 8, 1024)
    ks_k, val_k, f_slot, f_vals, common = _kernel_args(case, cuda)
    ks_p, val_p = ks_k.clone(), val_k.clone()
    got = serve_kernel.serve_fused(ks_k, val_k, f_slot, f_vals, *common)
    want = ref.serve_fused_plain(ks_p, val_p, f_slot, f_vals, *common)
    torch.cuda.synchronize()
    assert torch.equal(ks_k, ks_p) and torch.equal(val_k, val_p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ks_k, _, _, _, common = _kernel_args(case, cuda)
    ks_p = ks_k.clone()
    got = pac_kernel.probe_and_commit(ks_k, *common)
    want = ref.probe_and_commit_plain(ks_p, *common)
    torch.cuda.synchronize()
    assert torch.equal(ks_k, ks_p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _deep_case(seed, s, w, v, b, runs, oob_set=None, static_share=0.2):
    """``_case``'s state and batch with deep same-set runs: ``runs`` maps a
    set to its depth, and each run's requests (spread over the batch in
    arrival order) draw Zipf over the set's resident keys and three times
    as many new ones, with pads, static hits, non-admitted misses and
    epochs and floors on both sides of 2**31 among them (``static_share`` of
    them static hits).  ``oob_set``
    moves the first run to a set past the state (clamped on the gather,
    dropped on the scatter)."""
    case = _case(seed, s, w, v, b)
    rng = np.random.default_rng(seed + 7)
    e0 = 2**31 - 3
    case["ks"][:, 3 * w :] = torch.from_numpy(
        (e0 + rng.integers(-4, 5, size=(s, w))).astype(np.uint32).view(np.int32))
    case["epochs"] = torch.from_numpy(
        (e0 + rng.integers(-3, 8, size=b)).astype(np.uint32).view(np.int32))
    case["min_epoch"] = torch.from_numpy(
        (e0 + rng.integers(-5, 6, size=b)).astype(np.uint32).view(np.int32))
    set_idx = case["set_idx"].numpy()
    hot = np.array(list(runs))
    spare = np.setdiff1d(np.arange(s), hot)
    taken = np.isin(set_idx, hot)
    set_idx[taken] = rng.choice(spare, size=int(taken.sum()))
    free = rng.permutation(b)
    h_hi, h_lo = case["h_hi"].numpy(), case["h_lo"].numpy()
    for i, (hs, depth) in enumerate(runs.items()):
        run, free = np.sort(free[:depth]), free[depth:]
        set_idx[run] = hs
        pool_hi = np.concatenate([case["ks"][hs, :w].numpy(), _words(rng, 3 * w).numpy()])
        pool_lo = np.concatenate([case["ks"][hs, w : 2 * w].numpy(), _words(rng, 3 * w).numpy()])
        pool_hi[pool_hi == 0] = 9  # an empty way is not a key
        pick = np.minimum(rng.zipf(1.3, size=depth) - 1, 4 * w - 1)
        h_hi[run], h_lo[run] = pool_hi[pick], pool_lo[pick]
        h_hi[run[3::7]] = h_lo[run[3::7]] = -1  # pads
        case["static_hit"][run] = torch.from_numpy(rng.random(depth) < static_share)
        case["admit"][run] = torch.from_numpy(rng.random(depth) < 0.7)
        if i == 0 and oob_set is not None:
            set_idx[run] = oob_set
    return case


def _assert_kernels_equal_plain(case, dev):
    ks_k, val_k, f_slot, f_vals, common = _kernel_args(case, dev)
    ks_p, val_p = ks_k.clone(), val_k.clone()
    got = serve_kernel.serve_fused(ks_k, val_k, f_slot, f_vals, *common)
    want = ref.serve_fused_plain(ks_p, val_p, f_slot, f_vals, *common)
    torch.cuda.synchronize()
    assert torch.equal(ks_k, ks_p) and torch.equal(val_k, val_p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ks_k, _, _, _, common = _kernel_args(case, dev)
    ks_p = ks_k.clone()
    got = pac_kernel.probe_and_commit(ks_k, *common)
    want = ref.probe_and_commit_plain(ks_p, *common)
    torch.cuda.synchronize()
    assert torch.equal(ks_k, ks_p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


#: segment depths around the 32-request chunks a warp walks, and a whole
#: batch of 512 in one set
DEEP_DEPTHS = [1, 2, 3, 31, 32, 33, 64, 65, 355, 512]


@pytest.mark.parametrize("depth", DEEP_DEPTHS)
@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_deep_segments_on_the_card_equal_plain(cuda, depth, w):
    case = _deep_case(10 + depth, 64, w, 8, 512, {5: depth})
    assert int((case["set_idx"] == 5).sum()) == depth
    _assert_kernels_equal_plain(case, cuda)


def test_short_and_deep_segments_in_one_launch_on_the_card(cuda):
    # a serving batch's shape: thousands of one- to three-request segments
    # beside a few deep ones, one of them the whole warp's chunk plus one
    case = _deep_case(20, 1 << 14, 8, 8, 4096, {7: 33, 300: 100, 9000: 355, 16000: 80})
    _, _, _, _, common = _kernel_args(case, "cpu")
    seg_len = common[2]
    assert int((seg_len > 0).sum()) > 2000 and int(seg_len.max()) == 355
    _assert_kernels_equal_plain(case, cuda)


@pytest.mark.parametrize("v", [0, 1, 9, 40])
def test_value_rows_of_any_width_on_the_card(cuda, v):
    # the serve kernel holds 8 words a lane across the walk; wider rows take
    # the rest after it; rows of no words leave only the commit to launch
    case = _deep_case(50 + v, 64, 8, v, 512, {5: 100, 9: 33})
    _assert_kernels_equal_plain(case, cuda)


@pytest.mark.parametrize("depth,share", [(80, 1.0), (355, 1.0), (100, 0.9), (355, 0.6)])
def test_runs_of_static_hits_on_the_card(cuda, depth, share):
    # a serving batch's deepest segment is its head query, a static hit: a
    # run of requests that do not write is resolved at once
    case = _deep_case(40 + depth, 64, 8, 8, 512, {5: depth}, static_share=share)
    _assert_kernels_equal_plain(case, cuda)


@pytest.mark.parametrize("depth", [40, 355])
def test_deep_segment_out_of_range_on_the_card(cuda, depth):
    # the run's set is past the state: its rows clamp on the gather and its
    # writes drop
    case = _deep_case(30 + depth, 64, 8, 8, 512, {5: depth, 6: 20}, oob_set=64 + 3)
    assert int((case["set_idx"] == 67).sum()) == depth
    _assert_kernels_equal_plain(case, cuda)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    case = _case(4, 16, 4, 2, 40)
    ks, val, f_slot, f_vals, common = _kernel_args(case, cuda)
    with pytest.raises(TypeError):
        pac_kernel.probe_and_commit(ks.to(torch.int64), *common)
    with pytest.raises(ValueError):
        pac_kernel.probe_and_commit(ks.cpu(), *common)
    with pytest.raises(ValueError):
        serve_kernel.serve_fused(ks, val[:, :1].contiguous()[:-1], f_slot, f_vals, *common)
    with pytest.raises(ValueError):  # W > 32 has no kernel instance
        wide = torch.zeros((2, 4 * 33), dtype=torch.int32, device=cuda)
        args = list(common)
        pac_kernel.probe_and_commit(wide, *args)
        torch.cuda.synchronize()


def _backend(q):
    return np.tile(np.asarray(q)[:, None], (1, 4)).astype(np.int32) * 3 + 1


def _broker(device, one_call, fresh):
    rng = np.random.default_rng(0)
    topic_of_q = rng.integers(-1, 6, size=4000)
    cfg = DeviceCacheConfig.build(
        2048, f_s=0.2, f_t=0.5, topic_distinct={t: 10 + t for t in range(6)},
        ways=8, value_dim=4,
    )
    sq = np.arange(50)
    cache = STDDeviceCache(cfg, static_hashes=splitmix64(sq),
                           static_values=_backend(sq), device=device)
    return Broker(
        cache, [_backend], lambda q: topic_of_q[q], fused_one_call=one_call,
        freshness=FreshnessSpec(ttl_s=4.0, stale_policy=fresh) if fresh else None,
        bucket=BucketSpec(min_size=8), device=device,
    )


@pytest.mark.parametrize("one_call,fresh", [(True, None), (True, "miss"),
                                            (False, "serve_stale_while_revalidate")])
def test_broker_on_card_equals_broker_on_cpu(cuda, one_call, fresh):
    gpu, cpu = _broker("cuda", one_call, fresh), _broker("cpu", one_call, fresh)
    rng = np.random.default_rng(5)
    for i, n in enumerate([512, 300, 77, 512, 1, 256, 400] * 2):
        q = rng.zipf(1.2, size=n) % 4000
        gpu.advance_time(float(i))
        cpu.advance_time(float(i))
        v0, h0 = gpu.serve(q)
        v1, h1 = cpu.serve(q)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
        assert np.array_equal(v0, _backend(q))
    assert gpu.stats == cpu.stats
    gpu.flush()
    cpu.flush()
    a, b = state_to_numpy(gpu.state), state_to_numpy(cpu.state)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    gpu.close()
    cpu.close()


# -- migrations: the bulk insert of a live rebalance ------------------------------


def _migration_case(seed, s, w, n_real, n_pad, shrink, small_sets=4):
    """A migration batch into an empty layout of ``s`` sets: ``n_real``
    distinct live entries in stamp order, a partition of ``small_sets``
    sets shrunk by ``shrink`` (W * shrink entries land in each of its sets,
    the last W of each surviving), the rest spread over the other sets, and
    a tail of ``n_pad`` pads all in one set (the dynamic partition's), as
    ``bulk_insert`` pads a batch to its bucket."""
    rng = np.random.default_rng(seed)
    b = n_real + n_pad
    per_set = w * shrink
    n_small = small_sets * per_set
    set_idx = np.concatenate([
        np.repeat(np.arange(small_sets), per_set),
        rng.integers(small_sets, s, size=n_real - n_small),
    ])[rng.permutation(n_real)]
    h_hi, h_lo = _words(rng, n_real), _words(rng, n_real)
    h_hi[h_hi == 0] = 1
    pad_set = int(rng.integers(small_sets, s))
    return dict(
        ks=torch.zeros((s, 4 * w), dtype=torch.int32),
        h_hi=torch.cat([h_hi, torch.full((n_pad,), -1, dtype=torch.int32)]),
        h_lo=torch.cat([h_lo, torch.full((n_pad,), -1, dtype=torch.int32)]),
        set_idx=torch.from_numpy(np.concatenate([set_idx, np.full(n_pad, pad_set)])
                                 .astype(np.int32)),
        admit=torch.cat([torch.ones(n_real, dtype=torch.bool),
                         torch.zeros(n_pad, dtype=torch.bool)]),
        static_hit=torch.zeros(b, dtype=torch.bool),
        clock=torch.tensor(0, dtype=torch.int32),
        epochs=torch.cat([_words(rng, n_real), torch.zeros(n_pad, dtype=torch.int32)]),
        min_epoch=torch.zeros(b, dtype=torch.int32),
    )


@pytest.mark.parametrize("shrink", [8, 64])
def test_probe_and_commit_on_migration_batches_equals_plain(cuda, shrink):
    """A partition shrunk 8x (segments 64 deep) and 64x (512 deep), with a
    pow2 tail of 1024 pads in one set, against the plain version."""
    case = _migration_case(7, 2048, 8, 7168, 1024, shrink)
    before = pac_kernel.launches
    got = probe_and_commit_op(**_to(case, cuda))
    torch.cuda.synchronize()
    assert pac_kernel.launches == before + 1
    want = probe_and_commit_op(**_to(case, "cpu"))
    _assert_equal(got, want)
    assert int(want["wrote"].sum()) == 7168  # every migrant lands, no pad does


def _migration_caches(device, live, shrink):
    """A layout whose topic 0 is shrunk ``shrink``x from the one the
    ``live`` entries came from: 64 small sets, the rest topic 1 and the
    dynamic partition (where the bucket's pads go)."""
    cfg = DeviceCacheConfig(
        total_entries=2 * live, ways=8, value_dim=4,
        topic_entries={0: 64 * 8, 1: live // 2}, dynamic_entries=live // 2,
        static_entries=2 * live - 64 * 8 - live,
    )
    return STDDeviceCache(cfg, device=device)


@pytest.mark.parametrize("n_real", [(1 << 16) + 1000, (1 << 17) + 5000],
                         ids=["pad_tail_2^16", "B_2^18"])
def test_bulk_insert_on_card_equals_host_engine(cuda, n_real):
    """The real migration path, ``bulk_insert`` with the pow2 bucket, on the
    card (one ``probe_and_commit`` launch) against the numpy host engine:
    2**16 - 1000 pads in one set behind 2**16 + 1000 migrants, and a batch
    of 2**18.  The plain version replays every segment slot each round
    (O(depth x B)), minutes at these depths, so these two are held to the
    host engine, itself bit-exact with the reference (CPU tests)."""
    rng = np.random.default_rng(11)
    h64 = splitmix64(rng.permutation(1 << 24)[:n_real])
    # a sixth of the migrants are topic 0's: ~W * 25 per small set
    topics = np.where(rng.random(n_real) < 1 / 6, 0, rng.choice([1, -1], n_real))
    vals = rng.integers(0, 1 << 30, size=(n_real, 4)).astype(np.int32)
    eps = rng.integers(0, 1 << 32, size=n_real, dtype=np.uint64).astype(np.uint32)
    out = {}
    for dev, engine in ((cuda, "vec"), ("cpu", "host")):
        cache = _migration_caches(dev, n_real, 8)
        state = {k: v.clone() for k, v in cache.init_state.items()}
        before = pac_kernel.launches
        state = cache.bulk_insert(state, h64, topics, vals, epochs=eps, engine=engine,
                                  bucket=BucketSpec())
        if engine == "vec":
            torch.cuda.synchronize()
            assert pac_kernel.launches == before + 1
        out[engine] = state_to_numpy(state)
    assert int(out["host"]["clock"]) == BucketSpec().padded_len(n_real)
    for k in out["host"]:
        assert np.array_equal(out["vec"][k], out["host"][k]), k


def test_broker_rebalance_on_card_equals_host_engine(cuda):
    rb = RebalanceSpec(every=4, decay=0.8, min_interval=2, hysteresis=0.1)

    def make(device, engine):
        b = _broker(device, True, "miss")
        return Broker(b.cache, [_backend], b.topic_of, freshness=b.freshness_spec,
                      bucket=BucketSpec(min_size=8), rebalance=rb, engine=engine,
                      device=device)

    gpu, host = make(cuda, "device"), make("cpu", "host")
    rng = np.random.default_rng(9)
    topic_of_q = np.random.default_rng(0).integers(-1, 6, size=4000)
    launches = pac_kernel.launches
    for i in range(24):
        hot = np.flatnonzero(topic_of_q == (0 if i < 12 else 5))
        q = np.where(rng.random(256) < 0.8, rng.choice(hot, 256), rng.integers(0, 4000, 256))
        for b in (gpu, host):
            b.advance_time(float(i))
        v0, h0 = gpu.serve(q)
        v1, h1 = host.serve(q)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1), i
        if i == 18:
            assert gpu.rebalance(force=True) == host.rebalance(force=True)
    assert gpu.stats.rebalances >= 2 and gpu.stats.rebalances == host.stats.rebalances
    assert pac_kernel.launches >= launches + gpu.stats.rebalances  # the migrations
    assert gpu.cache.cfg == host.cache.cfg
    for k, v in dataclasses.asdict(gpu.stats).items():
        assert np.array_equal(v, getattr(host.stats, k)), k
    gpu.flush()
    a, b = state_to_numpy(gpu.state), state_to_numpy(host.state)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    gpu.close()
    host.close()


# -- topic_score -----------------------------------------------------------------

#: the sweep of tests/test_kernels.py, then the pipeline's chunk shape
TOPIC_SHAPES = [(4, 300, 37), (64, 1024, 500), (256, 513, 96), (8, 128, 8), (130, 640, 200),
                (8192, 4096, 96)]


def _topic_case(seed, b, v, k, zero_every=0, tie=None):
    """Seeded ``(counts, log_phi_t)`` on the CPU, as tests/test_kernels.py
    draws them; ``zero_every`` empties every n-th row, ``tie = (i, j)``
    makes topic columns i and j identical and the largest in every word,
    so every non-empty row ties between them."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(0.05, size=(b, v)).astype(np.float32)
    counts[:, 0] += 1.0
    if zero_every:
        counts[::zero_every] = 0.0
    lpt = np.log(rng.dirichlet(np.ones(v) * 0.1, size=k).T + 1e-12).astype(np.float32)
    if tie is not None:
        lpt[:, tie[0]] = lpt[:, tie[1]] = lpt.max(axis=1)
    return torch.from_numpy(counts), torch.from_numpy(np.ascontiguousarray(lpt))


def _assert_topic_close(got, want, same_conf=True):
    s, t, c = (x.cpu() for x in got)
    s0, t0, c0 = (x.cpu() for x in want)
    assert t.dtype == torch.int32 and s.shape == s0.shape
    torch.testing.assert_close(s, s0, rtol=1e-4, atol=1e-3)
    own = torch.softmax(s, dim=-1).gather(1, t.long()[:, None])[:, 0]
    torch.testing.assert_close(c, own, rtol=1e-4, atol=0.0)
    if same_conf:
        torch.testing.assert_close(c, c0, rtol=1e-4, atol=1e-4)
    differ = torch.nonzero(t != t0)[:, 0]
    gap = (s0[differ, t[differ].long()] - s0[differ, t0[differ].long()]).abs()
    assert bool((gap <= 1e-4 * s0[differ, t0[differ].long()].abs()).all()), differ


@pytest.mark.parametrize("b,v,k", TOPIC_SHAPES)
def test_topic_score_kernel_equals_plain_on_the_card(cuda, b, v, k):
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain product stays IEEE f32
    counts, lpt = (x.to(cuda) for x in _topic_case(b * 7 + k, b, v, k))
    before = ts_kernel.launches
    got = topic_score_op(counts, lpt)
    torch.cuda.synchronize()
    assert ts_kernel.launches == before + 1
    _assert_topic_close(got, topic_score_plain(counts, lpt), same_conf=v <= 1024)


@pytest.mark.parametrize("b,v,k", [(1000, 4097, 96), (37, 129, 1), (301, 1000, 500),
                                   (33, 17, 130)])
def test_topic_score_kernel_edge_cases_on_the_card(cuda, b, v, k):
    """All-zero rows (top 0, conf 1/K), K = 1, K = 500, B and V off every
    tile, and exact ties between two identical topic columns (the lower
    index wins)."""
    tie = (min(3, k - 1), min(7, k - 1)) if k > 1 else None
    counts, lpt = (x.to(cuda) for x in _topic_case(k, b, v, k, zero_every=9, tie=tie))
    s, t, c = topic_score_op(counts, lpt)
    torch.cuda.synchronize()
    _assert_topic_close((s, t, c), topic_score_plain(counts, lpt), same_conf=v <= 1024)
    zero = torch.arange(0, b, 9, device=cuda)
    assert bool((t[zero] == 0).all()) and bool((s[zero] == 0).all())
    torch.testing.assert_close(c[zero], torch.full_like(c[zero], 1.0 / k))
    if tie is not None and tie[0] != tie[1]:
        assert torch.equal(s[:, tie[0]], s[:, tie[1]])
        full = counts.sum(1) > 0
        assert bool((t[full] == tie[0]).all())


def _sparse_case(kind, b, v, k):
    """Counts for the redesign's cases: ``dense`` (every count non-zero),
    ``ends`` (a single non-zero per row, at word 0 or V - 1), ``zero`` (all
    rows empty), ``sparse`` (~1% non-zero, as the pipeline's chunks)."""
    rng = np.random.default_rng(b * 13 + v + k)
    if kind == "dense":
        counts = rng.integers(1, 4, size=(b, v)).astype(np.float32)
    elif kind == "ends":
        counts = np.zeros((b, v), np.float32)
        counts[0::2, 0] = rng.integers(1, 4, size=len(range(0, b, 2)))
        counts[1::2, v - 1] = rng.integers(1, 4, size=len(range(1, b, 2)))
    elif kind == "zero":
        counts = np.zeros((b, v), np.float32)
    else:
        counts = (rng.random((b, v)) < 0.01) * rng.integers(1, 4, size=(b, v))
        counts = counts.astype(np.float32)
    lpt = np.log(rng.dirichlet(np.ones(v) * 0.1, size=k).T + 1e-12).astype(np.float32)
    return torch.from_numpy(counts), torch.from_numpy(np.ascontiguousarray(lpt))


@pytest.mark.parametrize("kind,b,v,k", [
    ("dense", 300, 1000, 96), ("dense", 37, 4096, 33), ("ends", 41, 4096, 96),
    ("ends", 17, 1001, 500), ("zero", 25, 640, 96),
    *[("sparse", 203, 1003, k) for k in (1, 31, 32, 33, 96, 500, 600)],
    ("sparse", 8192, 4096, 96), ("sparse", 13, 5, 7),
])
def test_topic_score_kernel_over_the_non_zero_counts(cuda, kind, b, v, k):
    """The kernel takes FMAs for the non-zero counts only: a fully dense
    chunk, single non-zeros at words 0 and V - 1, all-zero rows, K on and
    off the lanes' 32-topic steps and past one pass (512 topics), B and V
    off every tile (V = 1003 and 5: one word a load)."""
    counts, lpt = (x.to(cuda) for x in _sparse_case(kind, b, v, k))
    before = ts_kernel.launches
    got = ts_kernel.topic_score(counts, lpt)
    torch.cuda.synchronize()
    assert ts_kernel.launches == before + 1
    # a dense row scores ~ -1e4, where two summation orders move conf (a
    # softmax of score differences) by ~1%: conf is held to the epilogue
    _assert_topic_close(got, topic_score_plain(counts, lpt),
                        same_conf=v <= 1024 and kind != "dense")
    if kind == "zero":
        s, t, c = got
        assert bool((s == 0).all()) and bool((t == 0).all())
        torch.testing.assert_close(c, torch.full_like(c, 1.0 / k))


def test_topic_score_kernel_on_rows_off_16_byte_alignment(cuda):
    """Counts whose rows start 4 bytes past a 16-byte boundary take one
    word a load; the sums and the epilogue are unchanged."""
    counts, lpt = (x.to(cuda) for x in _sparse_case("sparse", 64, 1000, 96))
    buf = torch.zeros(counts.numel() + 1, device=cuda)
    shifted = buf[1:].view(counts.shape).copy_(counts)
    assert ts_kernel.vec_width(shifted.data_ptr(), 1000) == 1
    got = ts_kernel.topic_score(shifted, lpt)
    want = ts_kernel.topic_score(counts, lpt)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)  # the same FMAs in the same order


def test_topic_score_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    counts, lpt = (x.to(cuda) for x in _topic_case(0, 16, 32, 4))
    with pytest.raises(TypeError):
        ts_kernel.topic_score(counts.double(), lpt)
    with pytest.raises(ValueError):
        ts_kernel.topic_score(counts, lpt.cpu())
    with pytest.raises(ValueError):
        ts_kernel.topic_score(counts, lpt.t().contiguous().t())
    with pytest.raises(ValueError):
        ts_kernel.topic_score(counts[:, :-1].contiguous(), lpt)
    s, t, c = ts_kernel.topic_score(counts[:0], lpt)
    assert s.shape == (0, 4) and t.shape == (0,) and c.shape == (0,)


def test_topic_pipeline_on_card_equals_cpu(cuda):
    """The whole topic pipeline (generate, EM with atomics, the kernel) on
    the card against the same on the CPU (the plain versions)."""
    from repro_torch.querylog import SynthConfig, generate
    from repro_torch.topics import run_pipeline

    cfg = SynthConfig(n_requests=40_000, n_topics=12, n_topical_queries=4_000,
                      n_notopic_queries=1_500, n_buckets=64, vocab_size=512, seed=4)
    gpu = run_pipeline(generate(cfg, device=cuda), lda_iters=8, lda_subsample=600, device=cuda)
    cpu = run_pipeline(generate(cfg, device="cpu"), lda_iters=8, lda_subsample=600, device="cpu")
    torch.testing.assert_close(gpu.model.phi.cpu(), cpu.model.phi, rtol=1e-6, atol=0.0)
    assert np.array_equal(gpu.assignment.key_topic, cpu.assignment.key_topic)
    # conf is a softmax of score differences, which two f32 summation orders
    # leave ~1e-4 apart at |scores| ~ 300
    np.testing.assert_allclose(gpu.assignment.confidence, cpu.assignment.confidence, rtol=1e-3)
    assert gpu.topical_request_fraction == cpu.topical_request_fraction


# -- decode_attention --------------------------------------------------------------

#: tests/test_kernels.py's sweep, then gemma2-27b's (Hkv 16, G 2, d 128,
#: softcap 50, window 4096), glm4-9b's (Hkv 2, G 16, d 128) and gemma-2b's
#: (Hkv 1, G 8, d 256) decode geometries at a shorter S, llama4-scout's
#: (Hkv 8, G 5, d 128) and arctic's (Hkv 8, G 7, d 128), S off every tile,
#: groups that are not a power of two or exceed 16, and narrow heads
DECODE_SHAPES = [
    (2, 2, 4, 64, 256, None, None),
    (1, 1, 8, 128, 1024, 50.0, 300),
    (3, 4, 1, 128, 777, None, None),
    (2, 1, 4, 256, 100, 30.0, 64),
    (1, 2, 2, 64, 513, None, 128),
    (2, 16, 2, 128, 8200, 50.0, 4096),
    (2, 2, 16, 128, 4133, None, None),
    (4, 1, 8, 256, 2081, None, None),
    (3, 8, 5, 128, 4133, None, None),
    (3, 8, 7, 128, 4133, None, None),
    (3, 1, 3, 64, 33, None, None),
    (2, 1, 3, 16, 70, 20.0, None),
    (1, 1, 32, 64, 300, None, 100),
]


def _decode_case(seed, b, hkv, g, d, s, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
               for shape in ((b, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)))
    return q, k, v


def _assert_decode_close(got, want):
    """2e-6 in f32; in bf16 one ulp of the plain output plus 1e-5 of its
    largest value (see the module's docstring)."""
    assert got.dtype == want.dtype
    if want.dtype == torch.float32:
        tol = dict(rtol=2e-6, atol=2e-6)
    else:
        tol = dict(rtol=2.0**-7, atol=1e-5 * float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("b,hkv,g,d,s,cap,win", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_equals_plain_on_the_card(cuda, b, hkv, g, d, s, cap, win, dtype):
    q, k, v = (x.to(cuda) for x in _decode_case(s + g, b, hkv, g, d, s, dtype))
    for cur in sorted({0, s // 3, s - 7, s - 1}):
        cur_t = torch.tensor(cur, dtype=torch.int32, device=cuda)
        before = da_kernel.launches
        got = decode_attention_op(q, k, v, cur_t, d**-0.5, cap, win)
        torch.cuda.synchronize()
        assert da_kernel.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        want = decode_attention_plain(q, k, v, cur_t, d**-0.5, cap, win)
        _assert_decode_close(got, want)


def _ring_curs(dev, b, hkv, g, d, s, dtype):
    """Fill levels at the bf16 kernel's box (one ring stage), ring-wrap and
    block boundaries for these shapes: one short of, at and one past the
    first box's end, the ring's wrap (every stage filled once) and the
    first place inside a pair where the persistent grid's plan for the
    full cache moves to another block."""
    if dtype != torch.bfloat16:
        return [0, s // 3, s - 1]
    tile = da_kernel.stage_keys(d)
    stages = da_kernel.ring_stages(d, tile)
    wrap = stages * tile
    grid = da_kernel._slots(dev.index or 0, g, d, 1, stages, da_kernel.head_slots(g, d), tile)
    tiles = -(-s // tile)
    total = b * hkv * tiles
    starts = {da_kernel.tile_range(i, total, grid)[0] % tiles * tile
              for i in range(min(grid, total))}
    chunk = min(starts - {0}, default=s)
    curs = {tile - 1, tile, tile + 1, wrap - 1, wrap, wrap + 1, chunk - 1, chunk, chunk + 1,
            s - 1, 0}
    return sorted(c for c in curs if 0 <= c < s)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_attention_tensor_core_kernel_on_the_card(cuda, g, d):
    """The bf16 kernel (mma.sync on the tensor cores, p as two bf16 halves,
    a ring of TMA tensor copies) against its plain version: G in {1, 2, 4,
    8, 16}, d in {64, 128, 256}, S off every box, the fill level at box,
    ring-wrap and block boundaries; with a softcap and a window on every
    other case."""
    s = 9 * da_kernel.stage_keys(d) + 37
    q, k, v = (x.to(cuda) for x in _decode_case(g * d + 1, 3, 1, g, d, s, torch.bfloat16))
    cap, win = (30.0, s // 4) if (g + d // 64) % 2 else (None, None)
    for cur in _ring_curs(cuda, 3, 1, g, d, s, torch.bfloat16):
        cur_t = torch.tensor(cur, dtype=torch.int32, device=cuda)
        got = decode_attention_op(q, k, v, cur_t, d**-0.5, cap, win)
        want = decode_attention_plain(q, k, v, cur_t, d**-0.5, cap, win)
        torch.cuda.synchronize()
        _assert_decode_close(got, want)


@pytest.mark.parametrize("hkv,g,d,cap,win", [(2, 8, 128, None, None), (4, 2, 256, 50.0, 300),
                                             (3, 16, 64, None, 90), (2, 4, 16, 20.0, None),
                                             (8, 5, 128, None, None), (8, 7, 128, None, None),
                                             (16, 2, 128, 50.0, 4096), (2, 16, 128, None, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_with_strided_heads(cuda, hkv, g, d, cap, win, dtype):
    """Hkv > 1: a kv head's rows are strided, and one TMA box copies a
    stage of them; the f32 path beside it.  The registry's Hkv > 1 decode
    geometries (llama4-scout's Hkv 8 G 5, arctic's G 7, gemma2-27b's Hkv
    16 G 2 with its softcap and window, glm4-9b's Hkv 2 G 16) at B 2 and S
    off every box, 20 boxes a pair, so blocks of the persistent grid span
    pairs; the fill level at box, ring-wrap and block boundaries."""
    s = 20 * da_kernel.stage_keys(d) + 11
    q, k, v = (x.to(cuda) for x in _decode_case(hkv * g + d, 2, hkv, g, d, s, dtype))
    for cur in _ring_curs(cuda, 2, hkv, g, d, s, dtype):
        cur_t = torch.tensor(cur, dtype=torch.int32, device=cuda)
        got = decode_attention_op(q, k, v, cur_t, d**-0.5, cap, win)
        want = decode_attention_plain(q, k, v, cur_t, d**-0.5, cap, win)
        torch.cuda.synchronize()
        _assert_decode_close(got, want)


@pytest.mark.parametrize("hkv,g,d", [(1, 8, 256), (8, 5, 128)])
def test_decode_attention_kernel_ignores_nan_past_the_fill(cuda, hkv, g, d):
    """Slots past cur_len may hold anything: NaN in K and in V there leaves
    the bf16 kernel's output bit for bit as it was, at fill levels where the
    last box is moved back to end at cur_len and where it ends on a box
    boundary; with and without a window, and through the window slice."""
    keys = da_kernel.stage_keys(d)
    s = 6 * keys + 5
    q, k, v = (x.to(cuda) for x in _decode_case(hkv + g + d, 2, hkv, g, d, s, torch.bfloat16))
    for cur in (0, 3, keys - 1, keys, 2 * keys + 17, 4 * keys - 1):
        cur_t = torch.tensor(cur, dtype=torch.int32, device=cuda)
        k2, v2 = k.clone(), v.clone()
        k2[:, cur + 1:] = float("nan")
        v2[:, cur + 1:] = float("nan")
        for kw in (dict(), dict(window=keys // 2 + 3), dict(window_slice=keys + 9)):
            o1 = decode_attention_op(q, k, v, cur_t, d**-0.5, **kw)
            o2 = decode_attention_op(q, k2, v2, cur_t, d**-0.5, **kw)
            torch.cuda.synchronize()
            assert torch.equal(o1, o2), (cur, kw)
            assert bool(torch.isfinite(o2.float()).all())


def test_decode_attention_kernel_in_a_cuda_graph(cuda):
    """The bf16 call captured in a CUDA graph (its tensor maps, persistent
    grid and the merge's programmatic dependent launch inside) replays bit
    for bit as eager calls, with cur_len moved on the card between
    replays."""
    b, hkv, g, d, s = 2, 8, 5, 128, 3000
    q, k, v = (x.to(cuda) for x in _decode_case(11, b, hkv, g, d, s, torch.bfloat16))
    cur = torch.tensor(100, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        decode_attention_op(q, k, v, cur, d**-0.5)  # warm-up off the graph
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = decode_attention_op(q, k, v, cur, d**-0.5)
    torch.cuda.current_stream(cuda).wait_stream(side)
    for c in (100, 1500, 2999, 7):
        cur.fill_(c)
        graph.replay()
        want = decode_attention_op(q, k, v, cur, d**-0.5)
        torch.cuda.synchronize()
        assert torch.equal(out, want), c
        _assert_decode_close(out, decode_attention_plain(q, k, v, cur, d**-0.5))


def test_decode_attention_kernel_reads_only_the_filled_cache(cuda):
    """tests/test_kernels.py's partial-fill case: poisoning the slots past
    cur_len changes nothing, in f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(cuda) for x in _decode_case(5, 1, 1, 2, 64, 512, dtype))
        cur = torch.tensor(100, dtype=torch.int32, device=cuda)
        o1 = decode_attention_op(q, k, v, cur, 64**-0.5)
        k2, v2 = k.clone(), v.clone()
        k2[:, 101:] = 1e9
        v2[:, 101:] = -1e9
        o2 = decode_attention_op(q, k2, v2, cur, 64**-0.5)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)


@pytest.mark.parametrize("b,hkv,g,d,s,w,cap", [
    (2, 16, 2, 128, 8200, 4096, 50.0),  # gemma2-27b's geometry, window 4096
    (1, 1, 8, 256, 2081, 512, None),
    (3, 2, 4, 64, 777, 100, 30.0),
    (2, 2, 16, 128, 300, 1024, None),  # a window past S: the whole cache
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_window_slice_on_the_card(cuda, b, hkv, g, d, s, w, cap, dtype):
    """The window-slice mode (the decode_window_slice lever): the split
    planned over the window's keys, the slice's start found from cur on
    the card; against the plain version's mode, at fill levels before,
    at and past the window, at the cache's last slot and past it."""
    q, k, v = (x.to(cuda) for x in _decode_case(s + w, b, hkv, g, d, s, dtype))
    for cur in sorted({0, 1, w - 1, w, w + 1, s // 2, s - 1, s, s + 5}):
        cur_t = torch.tensor(cur, dtype=torch.int32, device=cuda)
        before = da_kernel.launches
        got = decode_attention_op(q, k, v, cur_t, d**-0.5, cap, window_slice=w)
        torch.cuda.synchronize()
        assert da_kernel.launches == before + 1
        want = decode_attention_plain(q, k, v, cur_t, d**-0.5, cap, window_slice=w)
        _assert_decode_close(got, want)
        if cur < s:  # the same keys as the full read with the window
            _assert_decode_close(got, decode_attention_plain(q, k, v, cur_t, d**-0.5, cap, w))


@pytest.mark.parametrize("cur,win", [(40, None), (40, 4), (40, 20), (-3, None), (31, 1)])
def test_decode_attention_kernel_clamps_like_the_reference(cuda, cur, win):
    """cur >= S (every slot valid; with a window past the cache none, and
    the reference's softmax is uniform over S), cur < 0, window 1."""
    q, k, v = (x.to(cuda) for x in _decode_case(9, 2, 2, 4, 64, 32, torch.float32))
    cur_t = torch.tensor(cur, dtype=torch.int32, device=cuda)
    got = decode_attention_op(q, k, v, cur_t, 0.125, 30.0, win)
    want = decode_attention_plain(q, k, v, cur_t, 0.125, 30.0, win)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


def test_decode_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = (x.to(cuda) for x in _decode_case(1, 1, 1, 2, 64, 64, torch.float32))
    cur = torch.tensor(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        da_kernel.decode_attention(q, k.bfloat16(), v, cur, 0.1)
    with pytest.raises(TypeError):
        da_kernel.decode_attention(q.double(), k.double(), v.double(), cur, 0.1)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, k, v, cur.cpu(), 0.1)
    with pytest.raises(TypeError):
        da_kernel.decode_attention(q, k, v, cur.long(), 0.1)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, torch.cat([k, k], 3)[..., :64], v, cur, 0.1)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, k[:, :, :, :32].contiguous(), v, cur, 0.1)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 1, 32, 256, device=cuda)
        da_kernel.decode_attention(big, k.new_zeros(1, 8, 1, 256), k.new_zeros(1, 8, 1, 256),
                                   cur, 0.1)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, k, v, cur, 0.1, softcap=0.0)
    # head widths the kernel does not take: off the 16-byte grid, not a
    # divisor of 256, wider than 256; and K or V off 16-byte alignment
    for d, dtype in ((18, torch.float32), (4, torch.bfloat16), (40, torch.float32),
                     (512, torch.float32)):
        q2, k2, v2 = (x.to(cuda) for x in _decode_case(2, 1, 1, 2, d, 8, dtype))
        with pytest.raises(ValueError):
            da_kernel.decode_attention(q2, k2, v2, cur, 0.1)
    buf = torch.zeros(k.numel() + 1, device=cuda)
    shifted = buf[1:].view(k.shape).copy_(k)  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, shifted, v, cur, 0.1)
    with pytest.raises(ValueError):
        da_kernel.decode_attention(q, k, shifted, cur, 0.1)


def test_decode_steps_on_the_card_go_through_the_kernel(cuda):
    """A small gemma2-style LM (local/global layers, softcaps) in f32: the
    card's decode steps, one kernel launch per layer and step, against the
    same steps with the plain decode attention on the card (2e-5: only the
    attention's summation order differs) and on the CPU (1e-4: every
    product sums in another order)."""
    import dataclasses as dc

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = dc.replace(get_arch("gemma2-27b").smoke_config, n_layers=4, window=8)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 13)))
    runs = {}
    for name, dev, use_kernel in (("kernel", cuda, True), ("plain", cuda, False),
                                  ("cpu", torch.device("cpu"), True)):
        p = params.to(dev)
        _, cache = tf.prefill(p, tok.to(dev), cfg, max_len=20)
        before = da_kernel.launches
        out = []
        for step in range(5):
            nxt = torch.full((3, 1), 7 + step, device=dev)
            logits, cache = tf.decode_step(p, cache, nxt, cfg, use_kernel=use_kernel)
            out.append(logits.cpu())
        torch.cuda.synchronize()
        expect = 5 * cfg.n_layers if (use_kernel and dev.type == "cuda") else 0
        assert da_kernel.launches - before == expect
        runs[name] = torch.stack(out)
    torch.testing.assert_close(runs["kernel"], runs["plain"], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(runs["kernel"], runs["cpu"], rtol=1e-4, atol=1e-4)


# -- embedding_bag ---------------------------------------------------------------


def _bag_case(seed, v, d, b, l, dtype, index_dtype=torch.int32):
    """A table and (B, L) bags with pads anywhere, all-pad bags, bags of
    one, a repeated id and the last row."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dtype)
    bags = rng.integers(-1, v, size=(b, l))
    if b >= 4 and l >= 2:
        bags[0] = -1
        bags[1, 1:] = -1
        bags[2] = rng.integers(0, v)
        bags[3, ::2] = v - 1
    return table, torch.from_numpy(bags).to(index_dtype)


def _assert_bag_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if bool(torch.isnan(want).any()):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(got, want)


BAG_SHAPES = [(50, 128, 8, 5), (200, 256, 16, 9), (33, 128, 4, 3), (97, 18, 12, 6),
              (97, 50, 12, 6), (97, 64, 12, 6), (300, 256, 1, 4), (500, 300, 40, 40),
              (500, 8, 7, 100), (1000, 256, 64, 8)]


@pytest.mark.parametrize("v,d,b,l", BAG_SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_equals_plain_on_the_card(cuda, v, d, b, l, mode, dtype):
    """tests/test_kernels.py's sweep, D off the 32-lane grid (18, 50, 300),
    B = 1, bags longer than a warp's 32 ids (40, 100), int32 and int64 ids:
    bit for bit."""
    for index_dtype in (torch.int32, torch.int64):
        table, bags = (x.to(cuda) for x in _bag_case(v + d + l, v, d, b, l, dtype, index_dtype))
        before = eb_kernel.launches
        got = embedding_bag_op(table, bags, mode)
        torch.cuda.synchronize()
        assert eb_kernel.launches == before + 1
        _assert_bag_equal(got, embedding_bag_plain(table, bags, mode))
        _assert_bag_equal(got.cpu(), embedding_bag_plain(table.cpu(), bags.cpu(), mode))


def test_embedding_bag_kernel_at_a_million_rows_of_256(cuda):
    """A 1M x 256 f32 table (row offsets past 2**28 elements) and bags of
    two-tower's lengths: bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((1_000_000, 256), generator=gen, device=cuda)
    for b, l in ((4096, 8), (65_536, 4)):
        bags = torch.randint(0, 1_000_000, (b, l), generator=gen, device=cuda, dtype=torch.int32)
        length = torch.randint(1, l + 1, (b, 1), generator=gen, device=cuda)
        bags = torch.where(torch.arange(l, device=cuda) < length, bags, -1)
        bags[0, 0] = 999_999
        for mode in ("sum", "mean"):
            got = embedding_bag_op(table, bags, mode)
            assert torch.equal(got, embedding_bag_plain(table, bags, mode))


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def _bag_grad(table, bags, w, mode, use_kernel):
    t = table.clone().requires_grad_(True)
    (embedding_bag_op(t, bags, mode, use_kernel=use_kernel).float() * w).sum().backward()
    return t.grad


@pytest.mark.parametrize("v,d,b,l", [(50, 128, 8, 5), (97, 18, 12, 6), (1000, 256, 4096, 8),
                                     (500, 8, 7, 100)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_gradient_through_the_kernel_equals_plain(cuda, deterministic, v, d, b, l,
                                                                mode, dtype):
    """The table's gradient through the kernel (its forward, the op's
    ``index_add_`` backward) equals autograd's through the plain version,
    bit for bit under deterministic algorithms: pads, all-pad bags,
    repeated ids within and across bags.  In f32 also within rtol 1e-6 of
    the CPU's (the same sums; the card's sorted scatter may order a row's
    contributions otherwise)."""
    table, bags = (x.to(cuda) for x in _bag_case(v + 7 * d + l, v, d, b, l, dtype))
    w = torch.randn((b, d), generator=torch.Generator(device=cuda).manual_seed(d), device=cuda)
    before = eb_kernel.launches
    got = _bag_grad(table, bags, w, mode, True)
    want = _bag_grad(table, bags, w, mode, False)
    torch.cuda.synchronize()
    assert eb_kernel.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    if dtype == torch.float32:
        cpu = _bag_grad(table.cpu(), bags.cpu(), w.cpu(), mode, True)
        torch.testing.assert_close(got.cpu(), cpu, rtol=1e-6, atol=1e-7)


def test_embedding_bag_kernel_ids_past_the_table_give_nan(cuda):
    table, bags = (x.to(cuda) for x in _bag_case(4, 30, 64, 6, 4, torch.float32))
    bags[1] = torch.tensor([2, 30, -1, 1 << 30], dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        got = embedding_bag_op(table.to(dtype), bags, "mean")
        torch.cuda.synchronize()
        assert bool(torch.isnan(got[1]).all()) and not bool(torch.isnan(got[2:]).any())
        _assert_bag_equal(got, embedding_bag_plain(table.to(dtype), bags, "mean"))


def test_embedding_bag_kernel_empty_shapes(cuda):
    table = torch.randn(10, 40, device=cuda)
    before = eb_kernel.launches
    assert embedding_bag_op(table, torch.zeros((0, 3), dtype=torch.int32, device=cuda)).shape == (0, 40)
    assert eb_kernel.launches == before  # B = 0 launches nothing
    out = embedding_bag_op(table, torch.zeros((5, 0), dtype=torch.int32, device=cuda), "mean")
    torch.cuda.synchronize()
    assert out.shape == (5, 40) and bool((out == 0).all())


def test_embedding_bag_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    table, bags = (x.to(cuda) for x in _bag_case(1, 30, 32, 5, 4, torch.float32))
    with pytest.raises(ValueError, match="on"):
        eb_kernel.embedding_bag(table, bags.cpu())
    with pytest.raises(TypeError):
        eb_kernel.embedding_bag(table.double(), bags)
    with pytest.raises(TypeError):
        eb_kernel.embedding_bag(table, bags.float())
    with pytest.raises(ValueError, match="contiguous"):
        eb_kernel.embedding_bag(table.t(), bags)
    with pytest.raises(ValueError, match="mode"):
        eb_kernel.embedding_bag(table, bags, "max")


def test_two_tower_steps_on_the_card_go_through_the_kernel(cuda):
    """Two-tower's serve and retrieval steps at a wide smoke config: two
    kernel launches a step, equal to the plain path on the card, and within
    the CPU tests' f32 tolerance of the CPU."""
    import dataclasses as dc

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.models import recsys

    arch = get_arch("two-tower-retrieval")
    arch = dc.replace(arch, smoke_config=dc.replace(arch.smoke_config, embed_dim=256,
                                                    tower_dims=(64, 32)))
    params = recsys.init_two_tower(torch.Generator().manual_seed(0), arch.smoke_config)
    on_card = recsys.params_from_numpy(params, device=cuda)
    for shape in ("serve_p99", "retrieval_cand"):
        step = build_recsys_step(arch, arch.shape(shape), on_card,
                                 torch.Generator().manual_seed(1), cuda, smoke=True)
        before = eb_kernel.launches
        got = step.fn(step.batch)
        torch.cuda.synchronize()
        assert eb_kernel.launches == before + 2
        assert torch.equal(got, step.fn(step.batch, use_kernel=False))
        cpu = build_recsys_step(arch, arch.shape(shape), params,
                                torch.Generator().manual_seed(1), "cpu", smoke=True)
        torch.testing.assert_close(got.cpu(), cpu.fn(cpu.batch), rtol=1e-5, atol=1e-6)


def test_din_chunked_retrieval_on_the_card_equals_the_cpu(cuda):
    """DIN at its full widths (d 18, L 100, attention 80-40, MLP 200-80)
    with the table cut to 100,000 items: 20,000 candidates in chunks of
    4096 (a ragged tail of 3616) on the card against the CPU's chunks and
    the card's one pass (rtol 1e-5, atol 1e-6: the same f32 tolerance as
    the CPU tests), and the first chunk against the serve function on its
    materialised pairs, bit for bit (the same shapes)."""
    import dataclasses as dc

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.steps import build_recsys_step, recsys_fns
    from repro_torch.models import recsys

    arch = get_arch("din")
    shape = ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 20_000})
    arch = dc.replace(arch, config=dc.replace(arch.config, n_items=100_000), shapes=(shape,))
    params = recsys.init_din(torch.Generator().manual_seed(0), arch.config)
    on_card = recsys.params_from_numpy(params, device=cuda)
    card, cpu = (build_recsys_step(arch, shape, p, torch.Generator().manual_seed(1), dev)
                 for p, dev in ((on_card, cuda), (params, "cpu")))
    got = card.fn(card.batch, chunk_rows=4096)
    assert got.shape == (20_000,) and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), cpu.fn(cpu.batch, chunk_rows=4096), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(got, card.fn(card.batch, chunk_rows=20_000), rtol=1e-5,
                               atol=1e-6)
    serve_fn = recsys_fns(arch, arch.config)[0]
    pairs = {"hist": card.batch["hist"].expand(4096, -1).contiguous(),
             "target": card.batch["cands"][:4096]}
    assert torch.equal(got[:4096], serve_fn(on_card, pairs))


def test_four_shard_cluster_on_the_card_equals_the_host_engine_cluster(cuda):
    """A 4-shard cluster on the card (every shard on cuda:0, shard threads
    asked for) against the numpy host-engine cluster on one seeded stream:
    values, hit masks, stats and every shard's state, through synchronous
    and pipelined serving and a reshard 4 -> 2 (one probe_and_commit launch
    per new shard)."""
    from repro_torch.core.fast import VecLog, VecStats
    from repro_torch.core.spec import CacheSpec
    from repro_torch.serving import Cluster, DispatchSpec, ServingSpec

    rng = np.random.default_rng(3)
    keys = (rng.zipf(1.3, size=40_000) % 5000).astype(np.int64)
    topic = rng.integers(-1, 12, size=5000).astype(np.int64)
    log = VecLog(keys=keys, n_train=20_000, key_topic=topic)
    stats = VecStats.from_log(log)

    def backend(q):
        return np.tile(np.asarray(q)[:, None], (1, 4)).astype(np.int32)

    def make(engine, dev, **kw):
        spec = ServingSpec(cache=CacheSpec.from_strategy("STDv_LRU", 4096, f_s=0.3, f_t=0.5),
                           value_dim=4, microbatch=512, shards=4, routing="topic",
                           engine=engine, bucket=BucketSpec(), dispatch=DispatchSpec(max_fuse=4))
        return Cluster.from_spec(spec, stats, [backend], value_fn=backend, device=dev, **kw)

    # shard threads on one card (not the default there): the risky path
    card, host = make("device", "cuda", parallel=True), make("host", "cpu")
    assert all(b.device == torch.device("cuda", 0) for b in card.brokers)
    assert card._pool is not None
    test = log.test_keys
    batches = [test[lo : lo + 512] for lo in range(0, len(test), 512)]

    def same_state():
        card.flush()
        host.flush()
        for a, b in zip(card.brokers, host.brokers):
            x, y = state_to_numpy(a.state), state_to_numpy(b.state)
            assert all(np.array_equal(x[k], y[k]) for k in x)

    srv0 = serve_kernel.launches
    for q in batches[:20]:
        v0, h0 = card.serve(q)
        v1, h1 = host.serve(q)
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
        assert np.array_equal(v0, backend(q))
    assert serve_kernel.launches > srv0
    same_state()
    pac0 = pac_kernel.launches
    card.reshard(2)
    host.reshard(2)
    assert pac_kernel.launches - pac0 == 2
    same_state()
    rest = np.concatenate(batches[20:])
    outs = []
    for c in (card, host):
        futs = [c.serve_async(rest[lo : lo + 512]) for lo in range(0, len(rest), 512)]
        outs.append([f.result() for f in futs])
    for (v0, h0), (v1, h1) in zip(*outs):
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
    assert dataclasses.asdict(card.stats) == dataclasses.asdict(host.stats)
    same_state()
    card.close()
    host.close()


def test_graphed_lm_backend_equals_the_eager_one(cuda, monkeypatch):
    """The serving CLI's LM back end with its CUDA graphs (``graph_max``)
    against the eager one on gemma-2b's smoke config: the same doc ids at
    every size up to ``graph_max`` (rows padded to a power of two, or a
    call split across the graphs of its plan), past it (eager), and from
    four threads at once.  Once on the plans of the card's measured replay
    times, once on the plans of a compute-bound model's times, which split
    each size past 1024 that is not a power of two."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.serve import lm_backend
    from repro_torch.models import transformer as tf

    cfg = get_arch("gemma-2b").smoke_config
    params = tf.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    eager = lm_backend(params, cfg, 8, device=cuda)
    measured = lm_backend(params, cfg, 8, device=cuda, graph_max=4096)
    monkeypatch.setattr(serve, "_replay_costs", lambda graphs, dev: {g: 6.0 + 0.3 * g
                                                                     for g in graphs})
    split = lm_backend(params, cfg, 8, device=cuda, graph_max=4096)
    assert split.plans[1030] == (1024, 8) and split.plans[3000] == (2048, 512, 256, 128, 64)
    qids = np.random.default_rng(8).integers(0, 68_600_000, 5000)
    sizes = (1, 2, 3, 100, 1000, 1025, 1030, 1500, 2049, 3000, 4095, 4096, 5000)
    chunks = [qids[lo : lo + 700 + 37 * lo % 300] for lo in range(0, 4000, 500)]
    chunks += [qids[lo : lo + n] for lo, n in ((0, 1025), (100, 1030), (900, 1500), (2000, 3000))]
    for graphed in (measured, split):
        for n in sizes:
            want = eager(qids[:n])
            assert want.shape == (n, 8) and want.dtype == np.int32
            assert np.array_equal(graphed(qids[:n]), want)
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(graphed, chunks))
        for c, g in zip(chunks, got):
            assert np.array_equal(g, eager(c))
    lens = [n for n in sizes if n <= 4096] + [len(c) for c in chunks]
    for graphed in (measured, split):
        c = graphed.counters
        assert c["replays"] == sum(len(graphed.plans[n]) for n in lens)
        assert c["split_calls"] == sum(len(graphed.plans[n]) > 1 for n in lens)
        assert c["graph_rows"] == sum(sum(graphed.plans[n]) for n in lens) + 5000
        assert c["eager_calls"] == 1
    assert split.counters["split_calls"] >= 5  # 1025, 1030, 1500, 2049, 3000


@pytest.fixture(scope="module")
def analysis_log():
    """A seeded 2**20-request ``SynthConfig`` stream, 70% training, keys unseen
    in training without a topic, and its ``VecStats``."""
    from repro_torch.core import NO_TOPIC, VecLog, VecStats
    from repro_torch.querylog import SynthConfig, generate_stream

    keys, topic = generate_stream(SynthConfig(n_requests=1 << 20, seed=3))
    n_train = int(0.7 * len(keys))
    topic = topic.copy()
    topic[np.bincount(keys[:n_train], minlength=len(topic)) == 0] = NO_TOPIC
    log = VecLog(keys=keys, n_train=n_train, key_topic=topic)
    return log, VecStats.from_log(log)


@pytest.mark.parametrize("strategy", ["SDC", "STDf_LRU", "STDv_LRU", "STDv_SDC_C1",
                                      "STDv_SDC_C2", "Tv_SDC"])
def test_analysis_on_the_card_equals_the_cpu(cuda, analysis_log, strategy):
    """The reuse-distance engine's sorts and rank queries on the card give
    the CPU's arrays and hit counts, integer for integer."""
    from repro_torch.core import analyze, make_layout

    log, stats = analysis_log
    layout = make_layout(strategy, 1 << 15, stats, f_s=0.5, f_t=0.4, f_ts=0.5)
    card = analyze(log, layout, device=cuda)
    cpu = analyze(log, layout, device="cpu")
    assert card.rd.device.type == "cuda"
    for f in ("part_pos", "rd", "count_mask"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert card.hits(layout.capacity) == cpu.hits(layout.capacity) > 0
    hist, want = card.hit_histograms(1 << 15), cpu.hit_histograms(1 << 15)
    assert list(hist) == list(want)
    assert all(np.array_equal(hist[p], want[p]) for p in want)
