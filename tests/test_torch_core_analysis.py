"""The port's reuse-distance engine on the CPU against the JAX package's.

The same seeded numpy inputs go through ``repro.core`` (numpy, and the JAX
scan of ``repro.core.jax_sim``) and through ``repro_torch.core`` with
``device="cpu"``; everything is integer, so the tolerance is 0:

* reuse distances (``reuse_distances_offline`` on tensors,
  ``torch_sim.reuse_distances`` and the Fenwick oracle) for n = 0, 1, 2^k
  and 2^k +- 1;
* ``partitioned_prev``: the permutation and the previous occurrences;
* ``analyze`` for the six strategies and LRU, with and without an
  admission mask, warm and cold: every array of the ``TraceAnalysis``,
  ``hits`` at the layout's and at other capacities, ``hit_histograms``,
  ``static_hits``, ``hit_rate``; and ``lru_hits_all_sizes``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import fast as JF  # noqa: E402
from repro.core import jax_sim as JS  # noqa: E402
from repro.core import rd_offline as JR  # noqa: E402
from repro.querylog import synth as JQ  # noqa: E402
from repro_torch.core import fast as TF  # noqa: E402
from repro_torch.core import rd_offline as TR  # noqa: E402
from repro_torch.core import torch_sim as TS  # noqa: E402

STRATEGIES = ("LRU", "SDC", "STDf_LRU", "STDv_LRU", "STDv_SDC_C1", "STDv_SDC_C2", "Tv_SDC")
LOG = dict(n_requests=30_000, n_topics=8, n_topical_queries=3_000, n_notopic_queries=1_200,
           n_buckets=64, vocab_size=64, seed=7)


def _prev(keys):
    last, prev = {}, np.full(len(keys), -1, np.int64)
    for i, k in enumerate(keys.tolist()):
        prev[i] = last.get(k, -1)
        last[k] = i
    return prev


@pytest.mark.parametrize("n", [0, 1, 2, 3, 31, 32, 33, 1023, 1024, 1025])
def test_reuse_distances_equal_reference(n):
    rng = np.random.default_rng(n)
    prev = _prev(rng.integers(0, max(2, n // 3), size=n))
    want = JR.reuse_distances_offline(prev)
    assert np.array_equal(JS.reuse_distances(prev), want)  # the JAX scan agrees
    got = TR.reuse_distances_offline(torch.from_numpy(prev))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    got = TS.reuse_distances(prev, device="cpu")
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(TS.reuse_distances_py(prev), JS.reuse_distances_py(prev))


@pytest.mark.parametrize("n", [4095, 4096, 4097])
def test_offline_reuse_distances_equal_reference_on_a_skewed_stream(n):
    rng = np.random.default_rng(n)
    prev = _prev(rng.zipf(1.3, size=n) % 500)
    want = JR.reuse_distances_offline(prev)
    assert np.array_equal(TR.reuse_distances_offline(torch.from_numpy(prev)).numpy(), want)
    assert np.array_equal(TS.reuse_distances_py(prev), want)


@pytest.mark.parametrize("seed", range(4))
def test_partitioned_prev_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    keys = rng.integers(0, 200, size=n).astype(np.int64)
    # topic partitions and the dynamic cache's far larger id
    part = np.where(rng.random(n) < 0.3, JF.DYNAMIC_PART, rng.integers(0, 9, size=n))
    order, prev = JF.partitioned_prev(keys, part)
    got_order, got_prev = TF.partitioned_prev(torch.from_numpy(keys), torch.from_numpy(part))
    assert np.array_equal(got_order.numpy(), order)
    assert np.array_equal(got_prev.numpy(), prev)


def test_partitioned_prev_sorts_keys_too_wide_to_pack():
    """Keys up to 2^63 beside 40 partitions: no (partition, key) packing
    would fit in int64, and the chained stable sorts need none."""
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 50, size=500).astype(np.int64) * (1 << 58)
    part = rng.integers(0, 40, size=500).astype(np.int64)
    order, prev = JF.partitioned_prev(keys, part)
    got_order, got_prev = TF.partitioned_prev(torch.from_numpy(keys), torch.from_numpy(part))
    assert np.array_equal(got_order.numpy(), order) and np.array_equal(got_prev.numpy(), prev)


@pytest.fixture(scope="module")
def log():
    """The reference's synthetic log as a ``VecLog`` and both packages' stats."""
    synth = JQ.generate(JQ.SynthConfig(**LOG))
    n_train = int(0.6 * len(synth.keys))
    ref = JF.VecLog(keys=synth.keys, n_train=n_train, key_topic=synth.true_topic)
    port = TF.VecLog(keys=synth.keys, n_train=n_train, key_topic=synth.true_topic)
    return ref, port, JF.VecStats.from_log(ref), TF.VecStats.from_log(port)


def _same_analysis(got, want):
    assert np.array_equal(got.part_pos.numpy(), want.part_pos)
    assert np.array_equal(got.rd.numpy(), want.rd)
    assert np.array_equal(got.count_mask.numpy(), want.count_mask)


@pytest.mark.parametrize("admission", ["all", "mask"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("n_entries", [600, 20_000])
def test_analysis_equals_reference(log, n_entries, strategy, admission):
    """At 20,000 entries the sections outgrow their topics' training
    queries, so their static fractions take unseen keys too."""
    ref, port, jstats, tstats = log
    admitted = None
    if admission == "mask":
        admitted = np.random.default_rng(3).random(ref.n_queries) > 0.3
    kw = dict(f_s=0.3, f_t=0.4, f_ts=0.5, admitted=admitted)
    want_layout = JF.make_layout(strategy, n_entries, jstats, **kw)
    layout = TF.make_layout(strategy, n_entries, tstats, **kw)
    assert np.array_equal(layout.key_part, want_layout.key_part)
    assert layout.capacity == want_layout.capacity
    for warm in (True, False):
        want = JF.analyze(ref, want_layout, warm=warm)
        got = TF.analyze(port, layout, warm=warm, device="cpu")
        _same_analysis(got, want)
        assert TF.hit_rate(port, layout, warm=warm, device="cpu") == JF.hit_rate(
            ref, want_layout, warm=warm)
        for caps in (layout.capacity, {p: c // 3 for p, c in layout.capacity.items()},
                     {p: 10**6 for p in layout.capacity}, {}):
            hits = got.hits(caps)
            assert isinstance(hits, int) and hits == want.hits(caps)
        assert got.static_hits() == want.static_hits()
        hist, want_hist = got.hit_histograms(700), want.hit_histograms(700)
        assert list(hist) == list(want_hist)
        for p, h in want_hist.items():
            assert hist[p].dtype == h.dtype and np.array_equal(hist[p], h)


@pytest.mark.parametrize("warm", [True, False])
def test_lru_hits_all_sizes_equal_reference(log, warm):
    ref, port, _, _ = log
    want = JF.lru_hits_all_sizes(ref, 2000, warm=warm)
    got = TF.lru_hits_all_sizes(port, 2000, warm=warm, device="cpu")
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    assert np.all(np.diff(got) >= 0)


def test_analysis_entry_points_run_on_the_card_by_default(log):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    ref, port, _, tstats = log
    layout = TF.make_layout("SDC", 100, tstats, f_s=0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.analyze(port, layout)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.reuse_distances(np.array([-1, 0]))
