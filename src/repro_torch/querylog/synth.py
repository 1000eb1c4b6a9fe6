"""Synthetic query log, calibrated to the paper's measurements.

A copy of ``repro.querylog.synth.generate``: the same ``SynthConfig`` and
the same draws in the same order, so for one config every array is
identical to the reference's.  What the log carries:

* power-law query popularity (paper Fig. 4);
* k latent topics with Zipf topic popularity; 62% of requests topical;
* per-topic temporal locality: topic intensity modulated by daily /
  weekly cycles with topic-specific phases (paper Sec. 1);
* inside a topic, a stable flat core of recurring queries plus a
  high-churn Zipf tail;
* a no-topic Zipf pool and a large mass of fresh singletons;
* per-query surface features (term and character counts) for the
  admission policy;
* a click model: clicked-document text per requested topical query, drawn
  from topic-peaked word distributions, so the LDA pipeline
  (:mod:`repro_torch.topics`) can discover the topics the cache uses.

:func:`generate_stream` stops after the request stream.  :func:`generate`
goes on to the features and the documents.  :func:`generate_drifting` (a
piecewise-stationary stream whose topic popularity drifts, without
documents) and :func:`generate_invalidations` (seeded invalidation events on
a log's time axis) are copies of the reference's too, equal array for array
on one seed.  The documents are held in CSR
form (``doc_qid`` ascending, ``doc_offsets``, ``doc_tokens``) rather than
the reference's dict of one array per query: the same data, laid out for
a log of millions of documents.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

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
    #: vocabulary for clicked-document text
    vocab_size: int = 4096
    doc_len: Tuple[int, int] = (30, 80)
    #: per-topic word-distribution concentration (small = peaked topics)
    topic_dirichlet: float = 0.04
    #: background-word mixture weight inside a document
    background_mix: float = 0.2
    seed: int = 0


@dataclass
class SynthLog:
    """A generated log.  Query ids are dense in ``[0, n_queries)``.

    The clicked documents are in CSR form: document ``i`` belongs to query
    ``doc_qid[i]`` (ascending, one document per clicked query) and is
    ``doc_tokens[doc_offsets[i]:doc_offsets[i + 1]]``.
    """

    keys: np.ndarray  # (n,) int64 request stream
    timestamps: np.ndarray  # (n,) float64 days since epoch, ascending
    true_topic: np.ndarray  # (n_queries,) ground-truth topic or NO_TOPIC
    n_terms: np.ndarray  # (n_queries,) query length in words
    n_chars: np.ndarray  # (n_queries,) query length in characters
    doc_qid: np.ndarray  # (n_docs,) int64 clicked query ids, ascending
    doc_offsets: np.ndarray  # (n_docs + 1,) int64
    doc_tokens: np.ndarray  # (total tokens,) int32 word ids
    #: click count per query id (voting weight); None for a drift stream
    clicks: Optional[np.ndarray]  # (n_queries,) int64
    #: the generator's topic-word distributions (diagnostics only); None
    #: for a drift stream
    phi: Optional[np.ndarray]  # (n_topics, vocab_size) float64
    config: Optional[SynthConfig] = None

    @property
    def n_queries(self) -> int:
        return len(self.true_topic)

    @property
    def n_docs(self) -> int:
        return len(self.doc_qid)

    def split(self, train_frac: float) -> int:
        """Index splitting the stream into train/test by time order."""
        return int(len(self.keys) * train_frac)

    def doc(self, qid: int) -> np.ndarray:
        """The clicked-document tokens of query ``qid`` (``KeyError`` if it
        has none): the reference's ``docs[qid]``."""
        i = int(np.searchsorted(self.doc_qid, qid))
        if i == len(self.doc_qid) or self.doc_qid[i] != qid:
            raise KeyError(qid)
        return self.doc_tokens[self.doc_offsets[i] : self.doc_offsets[i + 1]]

    def docs_csr(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(offsets, tokens)`` of the documents at positions ``rows``, in
        that order."""
        off, tok = csr_rows(torch.from_numpy(self.doc_offsets), torch.from_numpy(self.doc_tokens),
                            torch.as_tensor(np.asarray(rows, np.int64)))
        return off.numpy(), tok.numpy()


def csr_rows(offsets: torch.Tensor, tokens: torch.Tensor, rows: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CSR ``(offsets, tokens)`` of the rows ``rows`` of a CSR, in that
    order, on the inputs' device (int64 offsets and rows)."""
    lens = offsets[rows + 1] - offsets[rows]
    out = torch.zeros(len(rows) + 1, dtype=torch.int64, device=offsets.device)
    torch.cumsum(lens, 0, out=out[1:])
    n = int(out[-1])
    pos = torch.repeat_interleave(offsets[rows] - out[:-1], lens, output_size=n)
    pos += torch.arange(n, device=offsets.device)
    return out, tokens[pos]


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
    return _draw_stream(np.random.default_rng(cfg.seed), cfg)


def _draw_stream(rng: np.random.Generator, cfg: SynthConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The stream's draws from ``rng`` (``generate``'s first part)."""
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


def generate(cfg: SynthConfig, device="cuda") -> SynthLog:
    """The whole log of ``cfg``: the stream, then the surface features, the
    topic-word distributions, the clicked documents and the click counts,
    drawn as the reference draws them.

    Every draw is numpy's, from one ``Generator`` seeded as the
    reference's.  The inverse-CDF lookups of the document words (~55 per
    document, 301M at 100x the default config) run on ``device`` with
    ``torch.searchsorted`` in float64: exact comparisons, so the words are
    the reference's bit for bit, without numpy's one-word-at-a-time binary
    search, the slowest step of the reference's generator at that size.
    """
    from ..core.device import resolve_device  # deferred: repro_torch.core imports this module

    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    keys, true_topic = _draw_stream(rng, cfg)
    k = cfg.n_topics
    n_queries = len(true_topic)

    # ----- query surface features (admission policy) -----------------------
    # popular queries are short; rare/singleton queries long (paper Sec. 5)
    freq = np.bincount(keys, minlength=n_queries)
    log_rarity = np.log1p(1.0 / np.maximum(freq, 1))
    n_terms = 1 + rng.poisson(0.25 + 0.8 * log_rarity)
    n_chars = (n_terms * (3 + rng.poisson(1.5, size=n_queries)) + 2).astype(np.int64)

    # ----- clicked-document text (LDA training substrate) ------------------
    v = cfg.vocab_size
    phi = rng.dirichlet(np.full(v, cfg.topic_dirichlet), size=k)  # (k, v)
    background = _zipf_pmf(v, 1.0)
    rng.shuffle(background)
    # only requested topical queries get documents (a click needs a
    # request), and 8% of them have no click at all
    requested = np.flatnonzero(freq > 0)
    topical_req = requested[true_topic[requested] != NO_TOPIC]
    has_click = rng.random(len(topical_req)) > 0.08
    clicked = topical_req[has_click]
    lens = rng.integers(cfg.doc_len[0], cfg.doc_len[1], size=len(clicked))
    phi_cdf = np.cumsum(phi, axis=1)
    bg_cdf = np.cumsum(background)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    total = int(starts[-1])
    words = torch.empty(total, dtype=torch.int32, device=dev)
    u = torch.from_numpy(rng.random(total)).to(dev)
    cdf = torch.from_numpy(phi_cdf).to(dev)
    # The reference draws each topic's words through a boolean mask over all
    # tokens.  ``clicked`` ascends and each topic owns one contiguous id
    # range, in topic order, so a topic's tokens are one contiguous run: a
    # slice gives the same words from the same draws.
    doc_topic = true_topic[clicked]
    tok_bounds = starts[np.searchsorted(doc_topic, np.arange(k + 1))]
    for t in range(k):
        lo, hi = int(tok_bounds[t]), int(tok_bounds[t + 1])
        if hi > lo:
            torch.searchsorted(cdf[t], u[lo:hi], right=True, out_int32=True, out=words[lo:hi])
    del u
    mix = torch.from_numpy(rng.random(total) < cfg.background_mix).to(dev)
    u_bg = torch.from_numpy(rng.random(int(mix.sum()))).to(dev)
    words[mix] = torch.searchsorted(torch.from_numpy(bg_cdf).to(dev), u_bg, right=True,
                                    out_int32=True)
    words = words.clamp_(0, v - 1).cpu().numpy()
    clicks = np.maximum(1, (freq * rng.beta(2, 5, size=n_queries))).astype(np.int64)

    return SynthLog(
        keys=keys,
        timestamps=np.linspace(0, cfg.n_days, cfg.n_requests),
        true_topic=true_topic,
        n_terms=n_terms.astype(np.int64),
        n_chars=n_chars,
        doc_qid=clicked.astype(np.int64),
        doc_offsets=starts,
        doc_tokens=words,
        clicks=clicks,
        phi=phi,
        config=cfg,
    )


# ---------------------------------------------------------------------------
# Time-varying popularity streams (popularity drift; Gao et al.)
# ---------------------------------------------------------------------------


@dataclass
class DriftConfig:
    """Piecewise-stationary topic popularity with drifting query mixtures.

    The stream is split into ``n_phases`` equal segments.  Within a phase
    everything is stationary; at each phase boundary the *topic*
    popularity ranking is re-drawn (a seeded permutation of the same Zipf
    shares -- yesterday's cold topic becomes today's hot one) and, with
    ``rotate_queries``, the *within-topic* Zipf head rotates through the
    topic's query pool (a drifting mixture of Zipf sources in the style
    of Gao et al.'s time-varying popularity model).  A cache allocation
    frozen on the first phase's statistics is therefore honestly stale
    for every later phase -- the scenario the drift rebalancer exists
    for, and the one ``benchmarks/fig_drift.py`` measures.

    Queries are dense ids: topic ``t`` owns ``[t*m, (t+1)*m)`` with
    ``m = queries_per_topic``; the stationary no-topic pool follows.
    """

    n_requests: int = 400_000
    n_topics: int = 24
    queries_per_topic: int = 1_500
    n_notopic_queries: int = 5_000
    topical_fraction: float = 0.85
    #: Zipf exponent over topic popularity ranks (per phase)
    zipf_topic: float = 1.1
    #: Zipf exponent over query ranks inside a topic (flat-ish: capacity,
    #: not a tiny hot head, is what buys hits)
    zipf_query: float = 0.7
    #: popularity phases; 1 = stationary (no drift)
    n_phases: int = 4
    #: rotate each topic's Zipf head at every phase boundary
    rotate_queries: bool = True
    #: of the no-topic requests, fraction that are fresh singletons --
    #: churn that pollutes a global LRU but never reaches the topic
    #: partitions (the isolation the paper's topic layer buys)
    singleton_fraction: float = 0.0
    seed: int = 0


def generate_drifting(cfg: DriftConfig) -> SynthLog:
    """Generate a piecewise-stationary drift stream (see ``DriftConfig``)."""
    rng = np.random.default_rng(cfg.seed)
    k, n, m = cfg.n_topics, cfg.n_requests, cfg.queries_per_topic
    phases = max(1, int(cfg.n_phases))
    base = _zipf_pmf(k, cfg.zipf_topic)
    # phase 0 keeps the identity ranking; later phases permute it
    perms = [np.arange(k)] + [rng.permutation(k) for _ in range(phases - 1)]
    phase_of = np.minimum((np.arange(n) * phases) // n, phases - 1)

    is_topical = rng.random(n) < cfg.topical_fraction
    keys = np.empty(n, dtype=np.int64)
    top_pos = np.flatnonzero(is_topical)
    q_cdf = np.cumsum(_zipf_pmf(m, cfg.zipf_query))
    for p in range(phases):
        sel = top_pos[phase_of[top_pos] == p]
        if not len(sel):
            continue
        share = np.empty(k)
        share[perms[p]] = base  # perms[p][j] is phase p's rank-j topic
        topic = rng.choice(k, size=len(sel), p=share)
        rank = np.searchsorted(q_cdf, rng.random(len(sel)), side="right")
        rank = np.minimum(rank, m - 1)
        if cfg.rotate_queries:
            # shift which queries form the Zipf head: same pool, new hot set
            rank = (rank + (p * m) // phases) % m
        keys[sel] = topic * m + rank

    nt_pos = np.flatnonzero(~is_topical)
    n_topical = k * m
    is_single = rng.random(len(nt_pos)) < cfg.singleton_fraction
    pool_pos = nt_pos[~is_single]
    if len(pool_pos):
        keys[pool_pos] = n_topical + _sample_zipf(
            rng, len(pool_pos), cfg.n_notopic_queries, 1.0
        )
    sing_pos = nt_pos[is_single]
    keys[sing_pos] = n_topical + cfg.n_notopic_queries + np.arange(len(sing_pos))
    n_queries = n_topical + cfg.n_notopic_queries + len(sing_pos)

    true_topic = np.full(n_queries, NO_TOPIC, dtype=np.int64)
    true_topic[:n_topical] = np.repeat(np.arange(k, dtype=np.int64), m)

    # surface features: enough for the admission policies to be applicable
    freq = np.bincount(keys, minlength=n_queries)
    n_terms = 1 + rng.poisson(0.5 + 0.6 * np.log1p(1.0 / np.maximum(freq, 1)))
    n_chars = (n_terms * 5 + 2).astype(np.int64)

    return SynthLog(
        keys=keys,
        timestamps=np.linspace(0, float(phases), n),  # one "day" per phase
        true_topic=true_topic,
        n_terms=n_terms.astype(np.int64),
        n_chars=n_chars,
        doc_qid=np.zeros(0, np.int64),
        doc_offsets=np.zeros(1, np.int64),
        doc_tokens=np.zeros(0, np.int32),
        clicks=None,
        phi=None,
        config=None,
    )


# ---------------------------------------------------------------------------
# Invalidation-event streams (freshness; docs/freshness.md)
# ---------------------------------------------------------------------------

#: event kinds in an :class:`InvalidationStream`
INVAL_KEY = 0
INVAL_TOPIC = 1


@dataclass
class InvalidationConfig:
    """Seeded invalidation processes riding a query stream's virtual time.

    Real backends re-crawl and re-rank: a result set becomes wrong, not
    just cold.  This models the two granularities the serving tier
    supports (see ``Broker.invalidate``): whole-topic flushes (an index
    segment for one topic was rebuilt) as independent per-topic Poisson
    processes, and single-key events (one query's results changed) as a
    popularity-weighted Poisson process over the stream's requested
    keys -- popular content is re-crawled more often.

    Rates are events per unit of the log's own time axis (days for
    :func:`generate`, phases for :func:`generate_drifting`), so one
    config composes with either stream family unchanged.
    """

    #: mean topic-flush events per topic per time unit
    topic_rate: float = 0.0
    #: mean key events per time unit (whole stream)
    key_rate: float = 0.0
    #: restrict topic events to these topics (None = every topic)
    topics: Optional[Tuple[int, ...]] = None
    #: weight key choice by request frequency (False = uniform over the
    #: distinct requested keys)
    popularity_weighted: bool = True
    seed: int = 0


@dataclass
class InvalidationStream:
    """Time-ordered invalidation events with a replay cursor.

    ``kinds[i]`` is :data:`INVAL_KEY` or :data:`INVAL_TOPIC`;
    ``targets[i]`` is the key id or topic id.  ``take_until`` is the
    replay interface: the harness (or any driver) calls it with each
    batch's dispatch time and applies the returned events before
    serving, so an episode replays bit-identically on any deployment.
    """

    times: np.ndarray  # (m,) float64, ascending
    kinds: np.ndarray  # (m,) int8
    targets: np.ndarray  # (m,) int64
    _cursor: int = 0

    def __len__(self) -> int:
        return len(self.times)

    def reset(self) -> None:
        self._cursor = 0

    def take_until(self, t: float) -> List[Tuple[int, int]]:
        """Consume and return every not-yet-replayed event with
        ``time <= t`` as ``(kind, target)`` pairs, in time order."""
        lo = self._cursor
        hi = int(np.searchsorted(self.times, float(t), side="right"))
        self._cursor = max(lo, hi)
        return [
            (int(self.kinds[i]), int(self.targets[i])) for i in range(lo, self._cursor)
        ]

    def apply(self, server, t: float) -> int:
        """Replay due events against a Broker/Cluster (anything with
        ``invalidate``); returns the number of events applied."""
        events = self.take_until(t)
        for kind, target in events:
            if kind == INVAL_TOPIC:
                server.invalidate(topic=target)
            else:
                server.invalidate(keys=np.asarray([target], np.int64))
        return len(events)


def generate_invalidations(
    cfg: InvalidationConfig, log: SynthLog
) -> InvalidationStream:
    """Draw an invalidation stream against ``log``'s time axis (seeded,
    independent of the query draw -- the same log composes with many
    invalidation scenarios)."""
    rng = np.random.default_rng(cfg.seed)
    t_end = float(log.timestamps[-1]) if len(log.timestamps) else 1.0
    t_end = max(t_end, 1e-9)
    times, kinds, targets = [], [], []

    topical = np.flatnonzero(log.true_topic != NO_TOPIC)
    all_topics = np.unique(log.true_topic[topical]) if len(topical) else np.array([], np.int64)
    topic_pool = (
        np.asarray(sorted(cfg.topics), np.int64)
        if cfg.topics is not None
        else all_topics
    )
    if cfg.topic_rate > 0:
        for t in topic_pool:
            m = int(rng.poisson(cfg.topic_rate * t_end))
            if m:
                times.append(rng.random(m) * t_end)
                kinds.append(np.full(m, INVAL_TOPIC, np.int8))
                targets.append(np.full(m, int(t), np.int64))

    if cfg.key_rate > 0:
        freq = np.bincount(log.keys, minlength=log.n_queries)
        requested = np.flatnonzero(freq > 0)
        if len(requested):
            m = int(rng.poisson(cfg.key_rate * t_end))
            if m:
                if cfg.popularity_weighted:
                    p = freq[requested].astype(np.float64)
                    p /= p.sum()
                    ks = rng.choice(requested, size=m, p=p)
                else:
                    ks = rng.choice(requested, size=m)
                times.append(rng.random(m) * t_end)
                kinds.append(np.full(m, INVAL_KEY, np.int8))
                targets.append(np.asarray(ks, np.int64))

    if not times:
        z = np.zeros(0)
        return InvalidationStream(z, z.astype(np.int8), z.astype(np.int64))
    times = np.concatenate(times)
    kinds = np.concatenate(kinds)
    targets = np.concatenate(targets)
    # deterministic total order: time, then kind, then target
    order = np.lexsort((targets, kinds, times))
    return InvalidationStream(times[order], kinds[order], targets[order])
