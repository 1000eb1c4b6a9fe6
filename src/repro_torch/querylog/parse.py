"""Parsers for the real-world query-log formats used by the paper (a copy
of ``repro.querylog.parse``).

The AOL and MSN logs cannot be redistributed, so these parsers exist as the
production ingestion path (unit-tested on synthetic fixtures): point them at
the original TSVs and the full pipeline runs on real data.

AOL record   : AnonID \t Query \t QueryTime \t ItemRank \t ClickURL
MSN record   : Time \t Query \t QueryID \t SessionID \t ResultCount
               (click rows join through a separate clicks file)

Preprocessing follows paper Sec. 4: lowercase, strip special characters,
collapse repeated click-through records of the same (user, query, time)
keeping only the first, and integer-encode queries in first-seen order.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

_NORM_RE = re.compile(r"[^a-z0-9 ]+")
_WS_RE = re.compile(r"\s+")


def normalize_query(q: str) -> str:
    """Lowercase, drop special characters, squeeze whitespace (paper Sec. 4)."""
    q = _NORM_RE.sub(" ", q.lower())
    return _WS_RE.sub(" ", q).strip()


@dataclass
class ParsedLog:
    """Integer-encoded stream + per-query metadata, ready for VecLog."""

    keys: np.ndarray  # (n,) int64
    timestamps: np.ndarray  # (n,) float64 (unix seconds)
    query_text: List[str]  # id -> normalized text
    #: clicked URL per record (empty string when no click)
    click_url: List[str] = field(default_factory=list)

    @property
    def n_queries(self) -> int:
        return len(self.query_text)

    def term_char_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        terms = np.array([len(t.split()) for t in self.query_text], dtype=np.int64)
        chars = np.array([len(t) for t in self.query_text], dtype=np.int64)
        return terms, chars


def _encode(records: Iterable[Tuple[str, float, str]]) -> ParsedLog:
    ids: Dict[str, int] = {}
    keys: List[int] = []
    ts: List[float] = []
    urls: List[str] = []
    texts: List[str] = []
    for q, t, url in records:
        qid = ids.get(q)
        if qid is None:
            qid = ids[q] = len(texts)
            texts.append(q)
        keys.append(qid)
        ts.append(t)
        urls.append(url)
    return ParsedLog(
        keys=np.asarray(keys, dtype=np.int64),
        timestamps=np.asarray(ts, dtype=np.float64),
        query_text=texts,
        click_url=urls,
    )


def parse_aol(lines: Iterable[str], has_header: bool = True) -> ParsedLog:
    """Parse AOL-format TSV lines.

    Repeated records for multi-click queries (same user, query, timestamp)
    are collapsed to the first, per paper Sec. 4 ("we kept only the first
    query of the sequence").
    """

    def gen() -> Iterator[Tuple[str, float, str]]:
        import calendar
        import time as _time

        last: Optional[Tuple[str, str]] = None
        it = iter(lines)
        if has_header:
            next(it, None)
        for line in it:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            user, raw_q, when = parts[0], parts[1], parts[2]
            url = parts[4] if len(parts) > 4 else ""
            q = normalize_query(raw_q)
            if not q:
                continue
            if last == (user, q):
                # additional click rows of the same submission: keep the
                # click join but not the duplicate stream entry
                continue
            last = (user, q)
            try:
                t = calendar.timegm(_time.strptime(when, "%Y-%m-%d %H:%M:%S"))
            except ValueError:
                continue
            yield q, float(t), url

    return _encode(gen())


def parse_msn(lines: Iterable[str], has_header: bool = True) -> ParsedLog:
    """Parse MSN (WSCD09) format TSV lines."""

    def gen() -> Iterator[Tuple[str, float, str]]:
        import calendar
        import time as _time

        it = iter(lines)
        if has_header:
            next(it, None)
        for line in it:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            when, raw_q = parts[0], parts[1]
            q = normalize_query(raw_q)
            if not q:
                continue
            try:
                t = calendar.timegm(
                    _time.strptime(when.split(".")[0], "%Y-%m-%d %H:%M:%S")
                )
            except ValueError:
                continue
            yield q, float(t), ""

    return _encode(gen())


def time_split(timestamps: np.ndarray, train_frac: float) -> int:
    """Stream index of the train/test boundary (streams are time-sorted)."""
    return int(len(timestamps) * train_frac)
