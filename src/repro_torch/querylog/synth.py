"""Synthetic query stream, calibrated to the paper's measurements.

A copy of the request-stream part of ``repro.querylog.synth.generate``:
the same ``SynthConfig`` and the same draws in the same order, so for one
config the keys and ground-truth topics are identical to the reference's.
What the stream carries:

* power-law query popularity (paper Fig. 4);
* k latent topics with Zipf topic popularity; 62% of requests topical;
* per-topic temporal locality: topic intensity modulated by daily /
  weekly cycles with topic-specific phases (paper Sec. 1);
* inside a topic, a stable flat core of recurring queries plus a
  high-churn Zipf tail;
* a no-topic Zipf pool and a large mass of fresh singletons.

The reference goes on to draw per-query surface features (for the
admission policy) and clicked-document text (for LDA); those draws come
after the stream's and are not copied: the port has no admission policy
or topic pipeline yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

#: sentinel topic id of an unclassified query
NO_TOPIC = -1


@dataclass
class SynthConfig:
    n_requests: int = 2_000_000
    n_topics: int = 96
    #: distinct topical queries (split across topics by Zipf shares)
    n_topical_queries: int = 300_000
    #: distinct non-singleton no-topic queries
    n_notopic_queries: int = 120_000
    #: fraction of requests that belong to some topic
    topical_fraction: float = 0.62
    #: of the no-topic requests, fraction that are fresh singletons
    singleton_fraction: float = 0.35
    #: Zipf exponent for query popularity inside a topic / the no-topic pool
    zipf_query: float = 1.05
    #: Zipf exponent for topic popularity
    zipf_topic: float = 0.85
    #: daily-cycle modulation amplitude per topic, drawn U[0, amp_max]
    amp_max: float = 0.9
    #: simulated duration in days (drives the periodic modulation)
    n_days: float = 21.0
    #: time buckets with piecewise-constant topic intensities
    n_buckets: int = 2048
    #: per-topic daily active-window length in days (~hours of burst)
    window_frac: float = 0.15
    #: background (out-of-window) topic intensity relative to in-window
    off_intensity: float = 0.3
    #: decouple topic traffic share from topic diversity (distinct-query
    #: count)
    decouple_diversity: bool = True
    #: fraction of a topic's pool forming its stable "core"
    core_frac: float = 0.06
    #: probability that a topical request targets the core
    p_core: float = 0.75
    #: Zipf exponent inside the core (flat: individually unpopular)
    zipf_core: float = 0.3
    #: daily core churn: fraction of core slots rotated into the tail
    core_churn: float = 0.0
    #: vocabulary for clicked-document text (unused by the stream)
    vocab_size: int = 4096
    doc_len: Tuple[int, int] = (30, 80)
    #: per-topic word-distribution concentration (unused by the stream)
    topic_dirichlet: float = 0.04
    #: background-word mixture weight inside a document (unused by the stream)
    background_mix: float = 0.2
    seed: int = 0


def _zipf_pmf(n: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def _sample_zipf(rng, n_draws: int, n_items: int, s: float) -> np.ndarray:
    """Inverse-CDF Zipf sampling (exact, vectorized)."""
    cdf = np.cumsum(_zipf_pmf(n_items, s))
    u = rng.random(n_draws)
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


def generate_stream(cfg: SynthConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The request stream of ``cfg``: ``(keys, true_topic)``.

    ``keys`` is the ``(n_requests,)`` int64 stream of dense query ids in
    time order; ``true_topic`` maps each id to its topic or ``NO_TOPIC``.
    """
    rng = np.random.default_rng(cfg.seed)
    k = cfg.n_topics
    n = cfg.n_requests

    # ----- topic universe ---------------------------------------------------
    topic_share = _zipf_pmf(k, cfg.zipf_topic)
    diversity = _zipf_pmf(k, cfg.zipf_topic).copy()
    if cfg.decouple_diversity:
        rng.shuffle(diversity)
    m_topic = np.maximum(
        32, np.round(diversity * cfg.n_topical_queries).astype(np.int64)
    )
    topic_offset = np.concatenate([[0], np.cumsum(m_topic)])
    n_topical = int(topic_offset[-1])
    n_nt = cfg.n_notopic_queries

    # ----- temporal topic intensities (piecewise-constant over buckets) ----
    b = cfg.n_buckets
    t_day = np.linspace(0, cfg.n_days, b, endpoint=False)
    phase_day = rng.random(k)  # window center, in fraction of a day
    phase_week = rng.random(k) * 2 * np.pi
    amp_week = rng.random(k) * cfg.amp_max * 0.6
    frac = t_day[:, None] - np.floor(t_day[:, None])  # time of day in [0,1)
    dist = np.abs(frac - phase_day[None, :])
    dist = np.minimum(dist, 1.0 - dist)  # circular distance to window center
    in_window = dist < (cfg.window_frac / 2)
    gate = np.where(in_window, 1.0, cfg.off_intensity)
    weekly = 1 + amp_week[None, :] * np.cos(2 * np.pi * t_day[:, None] / 7.0 - phase_week)
    inten = topic_share[None, :] * gate * np.maximum(weekly, 0.1)
    inten = np.maximum(inten, 1e-9)
    inten /= inten.sum(axis=1, keepdims=True)

    # ----- per-request layout ----------------------------------------------
    is_topical = rng.random(n) < cfg.topical_fraction
    bucket = np.minimum((np.arange(n) * b) // n, b - 1)
    keys = np.empty(n, dtype=np.int64)

    # topical requests: per-bucket multinomial topic counts, shuffled inside
    # the bucket
    top_pos = np.flatnonzero(is_topical)
    topics_of_pos = np.empty(len(top_pos), dtype=np.int64)
    bucket_of_top = bucket[top_pos]  # non-decreasing
    bounds = np.searchsorted(bucket_of_top, np.arange(b + 1))
    for bb in range(b):
        lo, hi = bounds[bb], bounds[bb + 1]
        if hi == lo:
            continue
        counts = rng.multinomial(hi - lo, inten[bb])
        block = np.repeat(np.arange(k), counts)
        rng.shuffle(block)
        topics_of_pos[lo:hi] = block
    # query choice inside a topic: a stable flat-ish core plus a Zipf tail
    n_days_i = int(np.ceil(cfg.n_days))
    day_of_pos = np.minimum(
        (np.arange(n, dtype=np.int64) * n_days_i) // n, n_days_i - 1
    )
    for t in range(k):
        sel = np.flatnonzero(topics_of_pos == t)
        if len(sel) == 0:
            continue
        m_t = int(m_topic[t])
        c_t = max(4, int(round(cfg.core_frac * m_t)))
        n_churn = int(round(cfg.core_churn * c_t))
        cores = np.tile(np.arange(c_t, dtype=np.int64), (n_days_i, 1))
        if n_churn and m_t > c_t:
            for dd in range(n_days_i):
                cores[dd, c_t - n_churn :] = c_t + (
                    (dd * n_churn + np.arange(n_churn)) % (m_t - c_t)
                )
        is_core = rng.random(len(sel)) < cfg.p_core
        days = day_of_pos[top_pos[sel]]
        qid = np.empty(len(sel), dtype=np.int64)
        n_core_req = int(is_core.sum())
        if n_core_req:
            ranks = _sample_zipf(rng, n_core_req, c_t, cfg.zipf_core)
            qid[is_core] = cores[days[is_core], ranks]
        n_tail_req = len(sel) - n_core_req
        if n_tail_req:
            if m_t > c_t:
                tail_ranks = _sample_zipf(rng, n_tail_req, m_t - c_t, cfg.zipf_query)
                qid[~is_core] = c_t + tail_ranks
            else:
                qid[~is_core] = _sample_zipf(rng, n_tail_req, m_t, cfg.zipf_query)
        keys[top_pos[sel]] = topic_offset[t] + qid

    # no-topic requests: Zipf pool + singleton tail
    nt_pos = np.flatnonzero(~is_topical)
    is_single = rng.random(len(nt_pos)) < cfg.singleton_fraction
    pool = _sample_zipf(rng, int((~is_single).sum()), n_nt, cfg.zipf_query)
    keys[nt_pos[~is_single]] = n_topical + pool
    n_singles = int(is_single.sum())
    keys[nt_pos[is_single]] = n_topical + n_nt + np.arange(n_singles)

    n_queries = n_topical + n_nt + n_singles
    true_topic = np.full(n_queries, NO_TOPIC, dtype=np.int64)
    for t in range(k):
        true_topic[topic_offset[t] : topic_offset[t + 1]] = t
    return keys, true_topic
