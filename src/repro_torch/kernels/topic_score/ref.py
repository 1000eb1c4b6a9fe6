"""Plain PyTorch version of the topic-score kernel.

score[b, t] = sum_v counts[b, v] * log_phi[t, v]; the query is assigned
its argmax topic with a softmax confidence (paper Sec. 3.3: argmax topic,
dropped below a confidence threshold).  Used by the CPU tests, by
``device="cpu"``, and on the card only to check the kernel against.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topic_score_plain(
    counts: torch.Tensor, log_phi_t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """counts (B, V) f32; log_phi_t (V, K) f32 (transposed topic-word).

    Returns ``(scores (B, K) f32, top (B,) int32, conf (B,) f32)``; ``top``
    is the first maximal index.
    """
    scores = counts @ log_phi_t
    top = torch.argmax(scores, dim=-1)
    conf = torch.softmax(scores, dim=-1).gather(1, top[:, None])[:, 0]
    return scores, top.to(torch.int32), conf
