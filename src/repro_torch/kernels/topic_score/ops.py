"""Public op: topic scoring.

``topic_score_op`` is the port of ``repro.kernels.topic_score.ops.
topic_score_op``.  The TPU op pads B, V and K to its tiles (K with -1e9
columns) and clamps ``top``; the CUDA kernel bounds-checks every axis
instead, so the op passes its operands through unpadded: on the card to
the kernel, on the CPU to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel


def topic_score_op(
    counts: torch.Tensor, log_phi_t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """counts (B, V) f32, log_phi_t (V, K) f32 ->
    (scores (B, K) f32, top (B,) int32, conf (B,) f32).

    An all-zero row scores 0 on every topic: ``top`` 0, ``conf`` 1/K."""
    return kernel.topic_score(counts.contiguous(), log_phi_t.contiguous())
