"""End-to-end topic pipeline: log -> LDA -> assignments -> cache stats
(port of ``repro.topics.pipeline``).

Mirrors the paper's data flow (Sec. 4): the training split provides (1)
query frequencies for the static cache, (2) the query+clicked-document
collection for LDA training and query classification, and (3) topic
popularity estimates for the proportional allocation; the test split is
replayed against the caches.  The LDA fit and the classification run on
``device``; the statistics are numpy, as the cache's planning is.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.fast import VecLog, VecStats
from ..querylog.synth import NO_TOPIC, SynthLog
from .assign import TopicAssignment, assign_topics_csr
from .lda import BagOfWords, LDAModel, em_train


@dataclass
class TopicPipelineResult:
    log: VecLog
    stats: VecStats
    model: LDAModel
    assignment: TopicAssignment
    #: fraction of test requests carrying a topic (paper: 65% AOL, 58% MSN)
    topical_request_fraction: float
    #: host-clock seconds of each stage, the device work included ("lda":
    #: bag of words + EM; "classify": every train-seen query; "stats")
    seconds: Dict[str, float] = field(default_factory=dict)


def _train_seen(synth: SynthLog, n_train: int) -> np.ndarray:
    train_seen = np.zeros(synth.n_queries, dtype=bool)
    train_seen[synth.keys[:n_train]] = True
    return train_seen


def _finish(synth: SynthLog, n_train: int, model: LDAModel, assignment: TopicAssignment,
            seconds: Dict[str, float]) -> TopicPipelineResult:
    t0 = time.perf_counter()
    log = VecLog(
        keys=synth.keys,
        n_train=n_train,
        key_topic=assignment.key_topic,
        key_terms=synth.n_terms,
        key_chars=synth.n_chars,
    )
    stats = VecStats.from_log(log)
    test_keys = synth.keys[n_train:]
    frac = float((assignment.key_topic[test_keys] != NO_TOPIC).mean()) if len(test_keys) else 0.0
    assignment.coverage = frac
    seconds["stats"] = time.perf_counter() - t0
    return TopicPipelineResult(
        log=log,
        stats=stats,
        model=model,
        assignment=assignment,
        topical_request_fraction=frac,
        seconds=seconds,
    )


def _done(dev: torch.device, t0: float) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def run_pipeline(
    synth: SynthLog,
    train_frac: float = 0.7,
    n_topics: Optional[int] = None,
    lda_iters: int = 30,
    lda_subsample: int = 30_000,
    confidence: float = 0.0,
    seed: int = 0,
    device="cuda",
) -> TopicPipelineResult:
    """Discover topics with LDA and build the vectorized log + stats."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_train = synth.split(train_frac)
    k = n_topics if n_topics is not None else synth.config.n_topics
    train_seen = _train_seen(synth, n_train)
    seconds: Dict[str, float] = {}

    # --- LDA training on a subsample of train-seen clicked documents -------
    # (in ascending query id order, as the reference's dict iterates)
    t0 = time.perf_counter()
    seen_rows = np.flatnonzero(train_seen[synth.doc_qid])
    if len(seen_rows) > lda_subsample:
        idx = rng.choice(len(seen_rows), size=lda_subsample, replace=False)
        sample_rows = seen_rows[idx]
    else:
        sample_rows = seen_rows
    offsets, tokens = synth.docs_csr(sample_rows)
    bow = BagOfWords.from_csr(offsets, tokens, synth.config.vocab_size, device=dev)
    model = em_train(bow, n_topics=k, n_iters=lda_iters, seed=seed)
    seconds["lda"] = _done(dev, t0)

    # --- classification of every train-seen query (one document each) ------
    t0 = time.perf_counter()
    assignment = assign_topics_csr(
        synth.n_queries, synth.doc_qid, synth.doc_offsets, synth.doc_tokens, model,
        train_seen, confidence=confidence,
    )
    seconds["classify"] = _done(dev, t0)
    return _finish(synth, n_train, model, assignment, seconds)


def oracle_pipeline(synth: SynthLog, train_frac: float = 0.7, device="cuda") -> TopicPipelineResult:
    """Ground-truth-topic variant (upper bound on classification quality)."""
    n_train = synth.split(train_frac)
    train_seen = _train_seen(synth, n_train)
    key_topic = np.where(train_seen, synth.true_topic, NO_TOPIC)
    assignment = TopicAssignment(
        key_topic=key_topic, confidence=np.ones(synth.n_queries, dtype=np.float32)
    )
    model = LDAModel.from_numpy(synth.phi, alpha=0.1, beta=0.01, device=device)
    return _finish(synth, n_train, model, assignment, {})
