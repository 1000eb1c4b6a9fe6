"""The port's topic pipeline on the CPU against the JAX package's
(``repro.querylog.synth.generate``, ``repro.topics``, ``repro.core.fast``),
on small seeded logs.

* ``generate``: every array identical, the CSR documents equal to the
  reference's dict of documents.
* ``BagOfWords.from_csr``: the reference's ``from_docs`` COO, element for
  element.
* ``em_train``: the same ``phi`` within rtol 1e-6 (float64 sums in another
  order); ``gibbs_train``: the same ``phi`` bit for bit (the same numpy draws).
* classification with a ``phi`` carried across (``LDAModel.from_numpy``):
  ``key_topic`` identical; confidences within rtol 1e-4
  (``tests/test_kernels.py``'s): a confidence is a softmax of score
  differences, and scores in the hundreds, summed in f32 in another
  order, differ by some ulps of ~3e-5.
* ``run_pipeline`` and ``oracle_pipeline`` end to end: ``key_topic``, the
  topical request fraction and every ``VecStats`` field identical.
* the slice as a whole: each package's pipeline planning a cache that its
  own broker serves with the LDA topics (the port's ``Broker(device=
  "cpu")``, the JAX ``Broker`` on its jnp path); hit masks, values and
  stats identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import serving as JS  # noqa: E402
from repro.core import fast as JF  # noqa: E402
from repro.querylog import synth as JQ  # noqa: E402
from repro.topics import assign as JA  # noqa: E402
from repro.topics import lda as JL  # noqa: E402
from repro.topics import pipeline as JP  # noqa: E402
from repro_torch import serving as TS  # noqa: E402
from repro_torch.core import fast as TF  # noqa: E402
from repro_torch.querylog import synth as TQ  # noqa: E402
from repro_torch.topics import assign as TA  # noqa: E402
from repro_torch.topics import lda as TL  # noqa: E402
from repro_torch.topics import pipeline as TP  # noqa: E402

SMALL = dict(n_requests=20_000, n_topics=8, n_topical_queries=1_500, n_notopic_queries=600,
             n_buckets=64, vocab_size=256, seed=5)
CONFIGS = {
    "small": SMALL,
    "churn": dict(SMALL, core_churn=0.25, decouple_diversity=False, n_topics=5,
                  singleton_fraction=0.6, n_days=3.5, doc_len=(3, 9), seed=9),
}


@pytest.fixture(scope="module")
def logs():
    """{config: (reference SynthLog, port SynthLog)}."""
    return {name: (JQ.generate(JQ.SynthConfig(**kw)),
                   TQ.generate(TQ.SynthConfig(**kw), device="cpu"))
            for name, kw in CONFIGS.items()}


def _bows(logs, n_docs=300):
    ref, port = logs["small"]
    docs = [ref.docs[q] for q in list(ref.docs)[:n_docs]]
    off, tok = port.docs_csr(np.arange(n_docs))
    return (JL.BagOfWords.from_docs(docs, 256),
            TL.BagOfWords.from_csr(off, tok, 256, device="cpu"), docs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_equals_reference(logs, name):
    ref, port = logs[name]
    for f in ("keys", "timestamps", "true_topic", "n_terms", "n_chars", "clicks", "phi"):
        want, got = getattr(ref, f), getattr(port, f)
        assert want.dtype == got.dtype and np.array_equal(want, got), f
    assert np.array_equal(np.fromiter(ref.docs, np.int64), port.doc_qid)
    assert np.array_equal(np.concatenate(list(ref.docs.values())), port.doc_tokens)
    for q in list(ref.docs)[::7]:
        assert np.array_equal(ref.docs[q], port.doc(q))
    with pytest.raises(KeyError):
        port.doc(int(np.setdiff1d(np.arange(port.n_queries), port.doc_qid)[0]))
    rows = np.array([5, 0, 3, 3])
    off, tok = port.docs_csr(rows)
    assert np.array_equal(tok, np.concatenate([port.doc(q) for q in port.doc_qid[rows]]))
    assert np.array_equal(np.diff(off), [len(port.doc(q)) for q in port.doc_qid[rows]])


def test_bag_of_words_from_csr_equals_reference_from_docs(logs):
    ref, port, docs = _bows(logs)
    also = TL.BagOfWords.from_docs(docs, 256, device="cpu")
    for f in ("doc", "word", "count"):
        want = getattr(ref, f)
        for bow in (port, also):
            got = getattr(bow, f).numpy()
            assert want.dtype == got.dtype and np.array_equal(want, got), f
    assert (port.n_docs, port.n_words) == (ref.n_docs, ref.n_words)
    with pytest.raises(ValueError):
        TL.BagOfWords.from_csr(np.array([0, 2]), np.array([1, 256]), 256, device="cpu")


@pytest.mark.parametrize("chunk", [262_144, 1_000])
def test_em_train_equals_reference(logs, chunk):
    ref, port, _ = _bows(logs)
    want = JL.em_train(ref, 8, n_iters=10, seed=2, chunk=chunk)
    got = TL.em_train(port, 8, n_iters=10, seed=2, chunk=chunk)
    assert got.phi.dtype == torch.float32 and got.phi.shape == want.phi.shape
    np.testing.assert_allclose(got.phi.numpy(), want.phi, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.log_phi().numpy(), want.log_phi(), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 4])
def test_gibbs_train_equals_reference(logs, seed):
    ref, _ = logs["small"]
    docs = [ref.docs[q] for q in list(ref.docs)[:40]]
    want = JL.gibbs_train(docs, n_topics=6, n_words=256, n_iters=3, seed=seed)
    got = TL.gibbs_train(docs, n_topics=6, n_words=256, n_iters=3, seed=seed, device="cpu")
    assert got.phi.dtype == torch.float32 and np.array_equal(got.phi.numpy(), want.phi)
    assert (got.alpha, got.beta) == (want.alpha, want.beta)


def test_classification_with_phi_carried_across(logs):
    ref, port, _ = _bows(logs)
    model = JL.em_train(ref, 8, n_iters=10, seed=3)
    carried = TL.LDAModel.from_numpy(model.phi, model.alpha, model.beta, device="cpu")
    top0, conf0 = JL.infer_argmax(model, ref)
    top1, conf1 = TL.infer_argmax(carried, port)
    assert top1.dtype == torch.int64 and np.array_equal(top0, top1.numpy())
    np.testing.assert_allclose(conf1.numpy(), conf0, rtol=1e-4)
    prior = np.linspace(1.0, 2.0, 8) / np.linspace(1.0, 2.0, 8).sum()
    np.testing.assert_allclose(TL.infer_scores(carried, port, prior=prior).numpy(),
                               JL.infer_scores(model, ref, prior=prior), rtol=1e-5)
    # a threshold drops low-confidence assignments to -1
    thr = float(np.median(conf0))
    t0, _ = JL.infer_argmax(model, ref, confidence=thr)
    t1, _ = TL.infer_argmax(carried, port, confidence=thr)
    assert np.array_equal(t0, t1.numpy()) and (t0 == -1).any()

    # assign_topics (mapping) and assign_topics_csr agree with the reference
    jlog, tlog = logs["small"]
    seen = np.zeros(tlog.n_queries, bool)
    seen[tlog.keys[: len(tlog.keys) // 2]] = True
    qd = {q: [(jlog.docs[q], int(jlog.clicks[q]))] for q in jlog.docs}
    want = JA.assign_topics(jlog.n_queries, qd, model, seen)
    for got in (TA.assign_topics(tlog.n_queries, qd, carried, seen),
                TA.assign_topics_csr(tlog.n_queries, tlog.doc_qid, tlog.doc_offsets,
                                     tlog.doc_tokens, carried, seen)):
        assert np.array_equal(got.key_topic, want.key_topic)
        np.testing.assert_allclose(got.confidence, want.confidence, rtol=1e-4)
    with pytest.raises(ValueError):
        TA.assign_topics_csr(tlog.n_queries, tlog.doc_qid[::-1], tlog.doc_offsets,
                             tlog.doc_tokens, carried, seen)


def _same_stats(a, b):
    for f in ("train_freq", "key_topic", "by_freq", "freq_rank", "notopic_rank", "topic_rank"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.topic_distinct == b.topic_distinct


def test_vec_stats_equal_reference_with_unseen_and_absent_topics():
    rng = np.random.default_rng(1)
    for n_train in (0, 7_000, 20_000):
        keys = rng.zipf(1.2, size=20_000) % 3_000
        kt = rng.integers(-1, 6, size=3_000)
        kt[kt == 4] = -1  # topic 4 labels nothing
        kt[rng.integers(0, 3_000, 5)] = 7  # a rare topic, maybe never seen
        _same_stats(JF.VecStats.from_log(JF.VecLog(keys, n_train, kt)),
                    TF.VecStats.from_log(TF.VecLog(keys, n_train, kt)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_pipeline_equals_reference(logs, name):
    ref, port = logs[name]
    kw = dict(train_frac=0.6, lda_iters=10, lda_subsample=400, seed=1)
    want = JP.run_pipeline(ref, **kw)
    got = TP.run_pipeline(port, device="cpu", **kw)
    assert np.array_equal(got.assignment.key_topic, want.assignment.key_topic)
    np.testing.assert_allclose(got.assignment.confidence, want.assignment.confidence, rtol=1e-4)
    assert got.topical_request_fraction == want.topical_request_fraction
    assert got.assignment.coverage == want.assignment.coverage
    np.testing.assert_allclose(got.model.phi.numpy(), want.model.phi, rtol=1e-6, atol=0)
    _same_stats(got.stats, want.stats)
    assert got.log.n_train == want.log.n_train
    assert set(got.seconds) == {"lda", "classify", "stats"}
    o0, o1 = JP.oracle_pipeline(ref, 0.6), TP.oracle_pipeline(port, 0.6, device="cpu")
    assert np.array_equal(o0.assignment.key_topic, o1.assignment.key_topic)
    assert o0.topical_request_fraction == o1.topical_request_fraction
    _same_stats(o0.stats, o1.stats)


def _serve_slice(mod, pipe, keys, where):
    """Plan a cache from ``pipe``'s statistics, as the serving CLI does, and
    serve ``keys`` with the pipeline's topics."""
    stats = pipe.stats
    cfg = mod.DeviceCacheConfig.build(512, f_s=0.25, f_t=0.5, topic_distinct=stats.topic_distinct,
                                      ways=4, value_dim=2)
    static = np.flatnonzero((stats.freq_rank < cfg.static_entries) & (stats.train_freq > 0))
    backend = lambda q: np.stack([np.asarray(q), np.asarray(q) * 3 + 1], 1).astype(np.int32)  # noqa: E731
    cache = mod.STDDeviceCache(cfg, static_hashes=mod.splitmix64(static),
                               static_values=backend(static),
                               **({"device": "cpu"} if mod is TS else {}))
    kt = pipe.assignment.key_topic
    broker = mod.Broker(cache, [backend], lambda q: kt[np.asarray(q)],
                        bucket=mod.BucketSpec(mode="explicit", sizes=(256,)), **where)
    out = []
    for i in range(0, len(keys), 256):
        q = keys[i : i + 256]
        v, h = broker.serve(q)
        assert np.array_equal(v, backend(q))
        out.append((v, h))
    broker.flush()
    return out, dataclasses.asdict(broker.stats), broker


def test_the_slice_serves_the_lda_topics_like_the_reference(logs):
    ref, port = logs["small"]
    kw = dict(train_frac=0.6, lda_iters=10, lda_subsample=400, seed=1)
    jp, tp = JP.run_pipeline(ref, **kw), TP.run_pipeline(port, device="cpu", **kw)
    keys = tp.log.test_keys[:3_000]
    want, wstats, jb = _serve_slice(JS, jp, keys, dict(engine="device", use_kernel=False))
    got, gstats, tb = _serve_slice(TS, tp, keys, dict(device="cpu"))
    for (v0, h0), (v1, h1) in zip(want, got):
        assert np.array_equal(v0, v1) and np.array_equal(h0, h1)
    for k in ("topic_counts",):
        wstats.pop(k), gstats.pop(k)
    assert wstats == gstats and gstats["topic_hits"] > 0
    mine = TS.state_to_numpy(tb.state)
    for k, v in mine.items():
        assert np.array_equal(np.asarray(jb.state[k]), v), k
    tb.close()


def test_entry_points_run_on_the_card_by_default(logs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, port = logs["small"]
    with pytest.raises(RuntimeError):
        TQ.generate(TQ.SynthConfig(**SMALL))
    with pytest.raises(RuntimeError):
        TP.run_pipeline(port)
    with pytest.raises(RuntimeError):
        TL.BagOfWords.from_csr(np.array([0, 1]), np.array([3]), 256)
    with pytest.raises(RuntimeError):
        TL.gibbs_train([np.array([1, 2])], 2, 4)
