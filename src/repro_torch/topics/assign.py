"""Query -> topic assignment (port of ``repro.topics.assign``, paper Sec.
3.3, "Query Topic Assignment").

A query may appear in several query-document pairs (several clicked
results), possibly classified into different topics.  The paper adopts a
voting scheme: the query receives the topic of the query-document pair
with the most clicks.  Assignments below a classification confidence are
dropped (the query competes for the dynamic cache instead), and only
queries *seen in the training stream* can carry a topic (unseen queries
have no clicked-document proxy).

:func:`assign_topics` keeps the reference's signature (a mapping of query
id to its pairs).  :func:`assign_topics_csr` takes one document per query
in CSR form, as the synthetic log holds them: the vote is then the
identity, and there is no per-query Python loop over millions of queries.
Both classify on the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..querylog.synth import NO_TOPIC, csr_rows
from .lda import BagOfWords, LDAModel, infer_argmax


@dataclass
class TopicAssignment:
    #: (n_queries,) predicted topic id or NO_TOPIC
    key_topic: np.ndarray
    #: (n_queries,) confidence of the assignment (0 where unassigned)
    confidence: np.ndarray
    #: fraction of *requests* in a stream carrying a topic (diagnostics)
    coverage: float = 0.0


def _assignment(n_queries: int, qids: np.ndarray, model: LDAModel, bow: BagOfWords,
                confidence: float) -> TopicAssignment:
    key_topic = np.full(n_queries, NO_TOPIC, dtype=np.int64)
    conf_arr = np.zeros(n_queries, dtype=np.float32)
    if len(qids):
        top, conf = infer_argmax(model, bow, confidence=confidence)
        key_topic[qids] = top.cpu().numpy()
        conf_arr[qids] = conf.cpu().numpy()
    return TopicAssignment(key_topic=key_topic, confidence=conf_arr)


def assign_topics(
    n_queries: int,
    query_docs: Mapping[int, Sequence[Tuple[np.ndarray, int]]],
    model: LDAModel,
    train_seen: np.ndarray,
    confidence: float = 0.0,
) -> TopicAssignment:
    """Assign one topic per query by click-weighted voting.

    ``query_docs`` maps query id -> [(doc tokens, click count), ...].
    ``train_seen`` is a boolean mask: only training-period queries are
    classifiable (paper: "the LDA classifier is able to classify only
    queries already seen in the training query log").
    """
    qids: List[int] = []
    docs: List[np.ndarray] = []
    for qid, pairs in query_docs.items():
        if not train_seen[qid] or not pairs:
            continue
        # voting: the most-clicked document represents the query
        best = max(pairs, key=lambda p: p[1])
        qids.append(qid)
        docs.append(best[0])
    bow = BagOfWords.from_docs(docs, model.n_words, device=model.device)
    return _assignment(n_queries, np.asarray(qids, np.int64), model, bow, confidence)


def assign_topics_csr(
    n_queries: int,
    doc_qid: np.ndarray,
    doc_offsets: np.ndarray,
    doc_tokens: np.ndarray,
    model: LDAModel,
    train_seen: np.ndarray,
    confidence: float = 0.0,
) -> TopicAssignment:
    """:func:`assign_topics` for one clicked document per query, in CSR
    form: query ``doc_qid[i]`` (strictly ascending) has the document
    ``doc_tokens[doc_offsets[i]:doc_offsets[i + 1]]``.  With one pair per
    query the vote picks that pair, so the result equals
    :func:`assign_topics` on ``{q: [(doc, clicks)]}``."""
    doc_qid = np.asarray(doc_qid, np.int64)
    if len(doc_qid) > 1 and not np.all(doc_qid[1:] > doc_qid[:-1]):
        raise ValueError("doc_qid must be strictly ascending: one document per query")
    rows = np.flatnonzero(train_seen[doc_qid])
    dev = model.device
    offsets, tokens = csr_rows(
        torch.as_tensor(np.asarray(doc_offsets, np.int64), device=dev),
        torch.as_tensor(np.asarray(doc_tokens), device=dev), torch.as_tensor(rows, device=dev),
    )
    bow = BagOfWords.from_csr(offsets, tokens, model.n_words, device=dev)
    return _assignment(n_queries, doc_qid[rows], model, bow, confidence)
