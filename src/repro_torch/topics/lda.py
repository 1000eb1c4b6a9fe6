"""Latent Dirichlet Allocation on PyTorch (port of ``repro.topics.lda``,
paper Sec. 3.3).

* :func:`em_train` -- vectorised MAP-EM over the sparse doc-word matrix
  (PLSA with Dirichlet smoothing == MAP LDA), in float64 on the model's
  device: the reference's chunked E/M steps with ``index_add_`` in place of
  ``np.add.at`` and the per-topic ``bincount``.
* :func:`infer_scores` / :func:`infer_argmax` -- classification of each
  document onto its argmax topic: a log-likelihood product that runs, one
  chunk of rows at a time, through the topic-score kernel
  (:mod:`repro_torch.kernels.topic_score`; ``csrc/topic_score.cu`` on the
  card, its plain version on the CPU).  The reference evaluates the same
  sum sparsely on the host.

* :func:`gibbs_train` -- the reference's collapsed Gibbs sampler, a
  sequential trainer off the pipeline's path: numpy on the host with the
  reference's draws, its ``phi`` moved to the model's device.

Every entry point that makes tensors takes ``device`` ("cuda" unless the
caller passes "cpu"); the others run where their inputs are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.topic_score import ops as topic_ops

#: documents per topic-score launch: (8192, V) dense f32 counts, 134 MB at
#: V = 4096
CHUNK_ROWS = 8192


@dataclass
class BagOfWords:
    """COO doc-word counts, sorted by (doc, word): parallel tensors on one
    device."""

    doc: torch.Tensor  # (nnz,) int32
    word: torch.Tensor  # (nnz,) int32
    count: torch.Tensor  # (nnz,) float32
    n_docs: int
    n_words: int

    @property
    def device(self) -> torch.device:
        return self.doc.device

    @classmethod
    def from_docs(
        cls, docs: Sequence[np.ndarray], n_words: int, device="cuda"
    ) -> "BagOfWords":
        """The reference's constructor: one ``np.unique`` per document."""
        dev = resolve_device(device)
        di, wi, ci = [], [], []
        for d, toks in enumerate(docs):
            w, c = np.unique(np.asarray(toks), return_counts=True)
            di.append(np.full(len(w), d, dtype=np.int32))
            wi.append(w.astype(np.int32))
            ci.append(c.astype(np.float32))
        cat = lambda xs, dt: torch.from_numpy(  # noqa: E731
            np.concatenate(xs) if xs else np.zeros(0, dt)
        ).to(dev)
        return cls(cat(di, np.int32), cat(wi, np.int32), cat(ci, np.float32),
                   len(docs), n_words)

    @classmethod
    def from_csr(cls, offsets, tokens, n_words: int, device="cuda") -> "BagOfWords":
        """Vectorised: document ``i`` is ``tokens[offsets[i]:offsets[i+1]]``
        (numpy arrays or tensors).

        The (doc, word) pairs are sorted and counted on ``device``; the COO
        is equal, element for element, to :meth:`from_docs` on the same
        documents.
        """
        dev = resolve_device(device)
        off = torch.as_tensor(offsets, device=dev).to(torch.int64)
        tok = torch.as_tensor(tokens, device=dev).to(torch.int64)
        n_docs = len(off) - 1
        if len(tok) and (int(tok.min()) < 0 or int(tok.max()) >= n_words):
            raise ValueError(f"token ids must lie in [0, {n_words})")
        doc_of = torch.repeat_interleave(
            torch.arange(n_docs, device=dev), off[1:] - off[:-1], output_size=len(tok)
        )
        pair, count = torch.unique(doc_of * n_words + tok, sorted=True, return_counts=True)
        return cls(
            (pair // n_words).to(torch.int32), (pair % n_words).to(torch.int32),
            count.to(torch.float32), n_docs, n_words,
        )


@dataclass
class LDAModel:
    phi: torch.Tensor  # (k, v) float32 topic-word distributions, on its device
    alpha: float
    beta: float

    @property
    def n_topics(self) -> int:
        return self.phi.shape[0]

    @property
    def n_words(self) -> int:
        return self.phi.shape[1]

    @property
    def device(self) -> torch.device:
        return self.phi.device

    def log_phi(self) -> torch.Tensor:
        return torch.log(torch.clamp(self.phi, min=1e-12))

    @classmethod
    def from_numpy(cls, phi: np.ndarray, alpha: float, beta: float, device="cuda") -> "LDAModel":
        """A model from host arrays (e.g. the JAX package's ``LDAModel.phi``),
        as float32 on ``device``."""
        dev = resolve_device(device)
        return cls(torch.from_numpy(np.asarray(phi, np.float32)).to(dev), float(alpha), float(beta))


def em_train(
    bow: BagOfWords,
    n_topics: int,
    n_iters: int = 40,
    alpha: float = 0.1,
    beta: float = 0.01,
    seed: int = 0,
    chunk: int = 262_144,
) -> LDAModel:
    """MAP-EM LDA on ``bow``'s device, in float64.  Memory-bounded: the
    (nnz, k) responsibility matrix is processed in chunks.  The initial
    topic-word draw is the reference's (``rng.dirichlet`` from a numpy
    ``Generator`` seeded ``seed``)."""
    dev = bow.device
    rng = np.random.default_rng(seed)
    k, v, nd = n_topics, bow.n_words, bow.n_docs
    # kept transposed, (v, k): a chunk's words gather whole rows
    phi_t = torch.from_numpy(rng.dirichlet(np.full(v, 1.0), size=k).T.copy()).to(dev)
    theta = torch.full((nd, k), 1.0 / k, dtype=torch.float64, device=dev)
    doc, word = bow.doc.to(torch.int64), bow.word.to(torch.int64)
    count = bow.count.to(torch.float64)
    nnz = len(doc)
    for _ in range(n_iters):
        n_dt = torch.zeros((nd, k), dtype=torch.float64, device=dev)
        n_wt = torch.zeros((v, k), dtype=torch.float64, device=dev)
        for lo in range(0, nnz, chunk):
            d, w = doc[lo : lo + chunk], word[lo : lo + chunk]
            r = theta[d] * phi_t[w]  # (chunk, k)
            r /= r.sum(dim=1, keepdim=True).clamp_min(1e-30)
            r *= count[lo : lo + chunk, None]
            n_dt.index_add_(0, d, r)
            n_wt.index_add_(0, w, r)
        theta = n_dt + alpha
        theta /= theta.sum(dim=1, keepdim=True)
        phi_t = n_wt + beta
        phi_t /= phi_t.sum(dim=0, keepdim=True)
    return LDAModel(phi=phi_t.T.contiguous().to(torch.float32), alpha=alpha, beta=beta)


def _dense_chunks(bow: BagOfWords, rows: int) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """``(r0, r1, counts)`` for each chunk of ``rows`` documents: the chunk's
    dense ``(r1 - r0, V)`` f32 counts, built on ``bow``'s device from the
    COO.  One buffer serves every chunk: each is consumed before the next
    is written (same stream)."""
    dev = bow.device
    starts = torch.arange(0, bow.n_docs + rows, rows, device=dev).clamp_(max=bow.n_docs)
    bounds = torch.searchsorted(bow.doc, starts.to(bow.doc.dtype)).tolist()
    buf = torch.empty((min(rows, bow.n_docs), bow.n_words), dtype=torch.float32, device=dev)
    for i, r0 in enumerate(range(0, bow.n_docs, rows)):
        r1 = min(r0 + rows, bow.n_docs)
        lo, hi = bounds[i], bounds[i + 1]
        counts = buf[: r1 - r0]
        counts.zero_()
        counts[bow.doc[lo:hi].to(torch.int64) - r0, bow.word[lo:hi].to(torch.int64)] = (
            bow.count[lo:hi]
        )
        yield r0, r1, counts


def infer_scores(
    model: LDAModel, bow: BagOfWords, prior: Optional[np.ndarray] = None
) -> torch.Tensor:
    """Per-document topic log-likelihood scores: (n_docs, k) f32 on the
    model's device.

    score[d, t] = sum_w count[d,w] * log phi[t, w]  (+ log prior), from the
    topic-score kernel one chunk of documents at a time.
    """
    lpt = model.log_phi().T.contiguous()  # (v, k)
    out = torch.zeros((bow.n_docs, model.n_topics), dtype=torch.float32, device=model.device)
    for r0, r1, counts in _dense_chunks(bow, CHUNK_ROWS):
        out[r0:r1] = topic_ops.topic_score_op(counts, lpt)[0]
    if prior is not None:
        lp = torch.as_tensor(np.asarray(prior, np.float64), device=model.device)
        out += torch.log(lp.clamp_min(1e-12)).to(torch.float32)[None, :]
    return out


def infer_argmax(
    model: LDAModel, bow: BagOfWords, confidence: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(topic int64, normalized confidence f32) per document, on the model's
    device; the paper keeps the argmax topic and drops assignments below a
    confidence threshold (topic -1).  Only the kernel's ``top`` and
    ``conf`` leave each chunk: the scores are not kept."""
    lpt = model.log_phi().T.contiguous()  # (v, k)
    top = torch.zeros(bow.n_docs, dtype=torch.int64, device=model.device)
    conf = torch.zeros(bow.n_docs, dtype=torch.float32, device=model.device)
    for r0, r1, counts in _dense_chunks(bow, CHUNK_ROWS):
        _, top[r0:r1], conf[r0:r1] = topic_ops.topic_score_op(counts, lpt)
    top = torch.where(conf >= confidence, top, torch.full_like(top, -1))
    return top, conf


def gibbs_train(
    docs: Sequence[np.ndarray],
    n_topics: int,
    n_words: int,
    n_iters: int = 100,
    alpha: float = 0.1,
    beta: float = 0.01,
    seed: int = 0,
    device="cuda",
) -> LDAModel:
    """Collapsed Gibbs sampling LDA (reference; paper Alg. 2 inverted).

    Per-token sequential sampling on the host, the reference's draws from
    a numpy ``Generator`` seeded ``seed`` in the same order, so ``phi`` is
    the reference's; it lands on ``device`` as float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    k, v = n_topics, n_words
    n_dk = np.zeros((len(docs), k), dtype=np.int64)
    n_kw = np.zeros((k, v), dtype=np.int64)
    n_k = np.zeros(k, dtype=np.int64)
    z: List[np.ndarray] = []
    for d, toks in enumerate(docs):
        zd = rng.integers(0, k, size=len(toks))
        z.append(zd)
        np.add.at(n_dk[d], zd, 1)
        np.add.at(n_kw, (zd, np.asarray(toks)), 1)
        np.add.at(n_k, zd, 1)
    for _ in range(n_iters):
        for d, toks in enumerate(docs):
            zd = z[d]
            for i, w in enumerate(toks):
                t_old = zd[i]
                n_dk[d, t_old] -= 1
                n_kw[t_old, w] -= 1
                n_k[t_old] -= 1
                p = (n_dk[d] + alpha) * (n_kw[:, w] + beta) / (n_k + v * beta)
                p = p / p.sum()
                t_new = rng.choice(k, p=p)
                zd[i] = t_new
                n_dk[d, t_new] += 1
                n_kw[t_new, w] += 1
                n_k[t_new] += 1
    phi = (n_kw + beta) / (n_kw.sum(axis=1, keepdims=True) + v * beta)
    return LDAModel.from_numpy(phi.astype(np.float32), alpha, beta, device=dev)
