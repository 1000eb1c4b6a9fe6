"""The benchmark's inputs: the query stream, its arrival times, the query
hash and the token windows, frozen here so that the program can change
without changing what the benchmark sends it.

``draw_stream`` is a copy of ``repro_torch.querylog.synth.generate_stream``
(the paper-calibrated query log: Zipf query popularity inside Zipf topics,
daily and weekly topic cycles, a no-topic pool and fresh singletons), draw
for draw.  ``arrival_times`` is a copy of
``repro_torch.loadgen.arrivals.ArrivalSpec.times`` (seeded Poisson and
on-off arrivals).  ``splitmix64`` and ``query_tokens`` restate the
program's query hash and the LM back end's token window of a query id:
they define the workload (which set a query lands in, which tokens the
back end scores), so the reference must compute them itself.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Tuple

import numpy as np

NO_TOPIC = -1
#: tokens in the stub query text of each query id (the back end's window)
QUERY_TOKENS = 8
#: the reserved pad hash; no real key hashes onto it or onto 0
PAD_H64 = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass
class StreamConfig:
    """``SynthConfig``'s stream fields with the defaults of the paper's
    calibration; ``scale`` multiplies the request and query counts (as
    ``benchmarks/common.py``'s ``scale`` does)."""

    n_requests: int = 2_000_000
    n_topics: int = 96
    n_topical_queries: int = 300_000
    n_notopic_queries: int = 120_000
    topical_fraction: float = 0.62
    singleton_fraction: float = 0.35
    zipf_query: float = 1.05
    zipf_topic: float = 0.85
    amp_max: float = 0.9
    n_days: float = 21.0
    n_buckets: int = 2048
    window_frac: float = 0.15
    off_intensity: float = 0.3
    decouple_diversity: bool = True
    core_frac: float = 0.06
    p_core: float = 0.75
    zipf_core: float = 0.3
    core_churn: float = 0.0
    seed: int = 0

    @classmethod
    def scaled(cls, scale: float, seed: int, **over) -> "StreamConfig":
        base = cls()
        known = {f.name for f in fields(cls)}
        bad = set(over) - known
        if bad:
            raise ValueError(f"unknown stream keys {sorted(bad)}")
        cfg = cls(
            n_requests=int(base.n_requests * scale),
            n_topical_queries=int(base.n_topical_queries * scale),
            n_notopic_queries=int(base.n_notopic_queries * scale),
            seed=seed,
        )
        for k, v in over.items():
            setattr(cfg, k, v)
        return cfg


def _zipf_pmf(n: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def _sample_zipf(rng, n_draws: int, n_items: int, s: float) -> np.ndarray:
    cdf = np.cumsum(_zipf_pmf(n_items, s))
    u = rng.random(n_draws)
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


def draw_stream(cfg: StreamConfig) -> Tuple[np.ndarray, np.ndarray]:
    """``(keys, true_topic)``: the ``(n_requests,)`` int64 stream of dense
    query ids in time order, and each id's topic or ``NO_TOPIC``."""
    rng = np.random.default_rng(cfg.seed)
    k = cfg.n_topics
    n = cfg.n_requests

    topic_share = _zipf_pmf(k, cfg.zipf_topic)
    diversity = _zipf_pmf(k, cfg.zipf_topic).copy()
    if cfg.decouple_diversity:
        rng.shuffle(diversity)
    m_topic = np.maximum(32, np.round(diversity * cfg.n_topical_queries).astype(np.int64))
    topic_offset = np.concatenate([[0], np.cumsum(m_topic)])
    n_topical = int(topic_offset[-1])
    n_nt = cfg.n_notopic_queries

    b = cfg.n_buckets
    t_day = np.linspace(0, cfg.n_days, b, endpoint=False)
    phase_day = rng.random(k)
    phase_week = rng.random(k) * 2 * np.pi
    amp_week = rng.random(k) * cfg.amp_max * 0.6
    frac = t_day[:, None] - np.floor(t_day[:, None])
    dist = np.abs(frac - phase_day[None, :])
    dist = np.minimum(dist, 1.0 - dist)
    in_window = dist < (cfg.window_frac / 2)
    gate = np.where(in_window, 1.0, cfg.off_intensity)
    weekly = 1 + amp_week[None, :] * np.cos(2 * np.pi * t_day[:, None] / 7.0 - phase_week)
    inten = topic_share[None, :] * gate * np.maximum(weekly, 0.1)
    inten = np.maximum(inten, 1e-9)
    inten /= inten.sum(axis=1, keepdims=True)

    is_topical = rng.random(n) < cfg.topical_fraction
    bucket = np.minimum((np.arange(n) * b) // n, b - 1)
    keys = np.empty(n, dtype=np.int64)

    top_pos = np.flatnonzero(is_topical)
    topics_of_pos = np.empty(len(top_pos), dtype=np.int64)
    bucket_of_top = bucket[top_pos]
    bounds = np.searchsorted(bucket_of_top, np.arange(b + 1))
    for bb in range(b):
        lo, hi = bounds[bb], bounds[bb + 1]
        if hi == lo:
            continue
        counts = rng.multinomial(hi - lo, inten[bb])
        block = np.repeat(np.arange(k), counts)
        rng.shuffle(block)
        topics_of_pos[lo:hi] = block
    n_days_i = int(np.ceil(cfg.n_days))
    day_of_pos = np.minimum((np.arange(n, dtype=np.int64) * n_days_i) // n, n_days_i - 1)
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
                cores[dd, c_t - n_churn:] = c_t + ((dd * n_churn + np.arange(n_churn)) % (m_t - c_t))
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
                qid[~is_core] = c_t + _sample_zipf(rng, n_tail_req, m_t - c_t, cfg.zipf_query)
            else:
                qid[~is_core] = _sample_zipf(rng, n_tail_req, m_t, cfg.zipf_query)
        keys[top_pos[sel]] = topic_offset[t] + qid

    nt_pos = np.flatnonzero(~is_topical)
    is_single = rng.random(len(nt_pos)) < cfg.singleton_fraction
    pool = _sample_zipf(rng, int((~is_single).sum()), n_nt, cfg.zipf_query)
    keys[nt_pos[~is_single]] = n_topical + pool
    n_singles = int(is_single.sum())
    keys[nt_pos[is_single]] = n_topical + n_nt + np.arange(n_singles)

    true_topic = np.full(n_topical + n_nt + n_singles, NO_TOPIC, dtype=np.int64)
    for t in range(k):
        true_topic[topic_offset[t]:topic_offset[t + 1]] = t
    return keys, true_topic


def arrival_times(process: str, rate: float, n: int, seed: int, burst: float = 4.0,
                  on_frac: float = 0.2, mean_on_s: float = 0.02) -> np.ndarray:
    """``n`` nondecreasing arrival times in seconds from 0: a Poisson
    process at ``rate``, or an on-off process whose ON state runs at
    ``burst * rate`` a share ``on_frac`` of the time (mean ``rate``)."""
    rng = np.random.default_rng(seed)
    if process == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, size=n))
    if process != "onoff":
        raise ValueError(f"unknown arrival process {process!r}")
    if not (burst >= 1.0 and 0.0 < on_frac < 1.0 and burst * on_frac <= 1.0 + 1e-12):
        raise ValueError("onoff needs burst >= 1, 0 < on_frac < 1, burst * on_frac <= 1")
    rate_on = rate * burst
    rate_off = rate * (1.0 - burst * on_frac) / (1.0 - on_frac)
    mean_off = mean_on_s * (1.0 - on_frac) / on_frac
    out, remaining, t = [], n, 0.0
    on = bool(rng.random() < on_frac)
    while remaining > 0:
        dur = float(rng.exponential(mean_on_s if on else mean_off))
        r = rate_on if on else rate_off
        if r > 0 and dur > 0:
            k = min(int(rng.poisson(r * dur)), remaining)
            if k:
                out.append(t + np.sort(rng.random(k)) * dur)
                remaining -= k
        t += dur
        on = not on
    return np.concatenate(out)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The 64-bit query hash (uint64); 0 and the pad hash are reserved and
    remapped, as the serving tier defines them."""
    x64 = np.asarray(x).astype(np.int64, copy=False).astype(np.uint64)
    is_pad = x64 == PAD_H64
    with np.errstate(over="ignore"):
        z = x64 + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    z[z == 0] = 1
    z[z == PAD_H64] = PAD_H64 ^ np.uint64(1)
    z[is_pad] = PAD_H64
    return z


def query_tokens(qids: np.ndarray, vocab_size: int) -> np.ndarray:
    """(n, 8) int64 token windows of the query ids: the back end's input."""
    q = np.asarray(qids).astype(np.int64)
    return (q[:, None] * 31 + np.arange(QUERY_TOKENS)[None, :]) % vocab_size
