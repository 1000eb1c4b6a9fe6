"""The LM back end that the serving CLI puts behind the cache: the port of
``repro.launch.serve``'s ``model_scores`` / ``backend`` pair.

On a miss the CLI turns each query id into a stub token window,
``(q * 31 + arange(8)) % vocab``, runs the LM over it, and answers with the
``value_dim`` best-scoring vocabulary ids of the last position, the lower
id first among equal logits (``jax.lax.top_k``'s order).  The reference
computes the whole ``(n, 8, V)`` logits with ``forward`` and keeps the last
position; the port unembeds only the last position, as ``prefill`` does:
the same ids, without the ``(n, 8, 256000)`` f32 logits at full width.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import transformer as tf

#: tokens of the stub query text per query id
QUERY_TOKENS = 8


def query_tokens(qids: np.ndarray, vocab_size: int) -> np.ndarray:
    """(n, 8) int64 token windows derived from the query ids."""
    q = np.asarray(qids).astype(np.int64)
    return (q[:, None] * 31 + np.arange(QUERY_TOKENS)[None, :]) % vocab_size


def top_k_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest entries' indices per row, descending, the lower
    index first among equal values (as ``jax.lax.top_k``): a stable sort,
    since ``torch.topk`` on the card does not fix the order of ties."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


@torch.no_grad()
def model_scores(params: tf.ParamTree, tokens: torch.Tensor, cfg: tf.TransformerConfig,
                 k: int) -> torch.Tensor:
    """(n, k) int32: the top-k vocabulary ids of each window's last position."""
    x = tf.hidden(params, tokens, cfg)
    return top_k_ids(tf._unembed(params, x[:, -1], cfg), k).to(torch.int32)


def lm_backend(params: tf.ParamTree, cfg: tf.TransformerConfig, value_dim: int = 8,
               device="cuda") -> Callable[[np.ndarray], np.ndarray]:
    """``backend(qids) -> (n, value_dim) int32`` doc ids, as the CLI's."""
    dev = resolve_device(device)

    def backend(qids: np.ndarray) -> np.ndarray:
        tokens = torch.from_numpy(query_tokens(qids, cfg.vocab_size)).to(dev)
        return model_scores(params, tokens, cfg, value_dim).cpu().numpy()

    return backend
