"""The yardstick's arithmetic: the H100's published peaks, the model FLOPs
of one back-end row, and the bytes one serve-kernel call must move.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989.4
TFLOP/s in bf16 and 3.35 TB/s of HBM.
"""
from __future__ import annotations

import numpy as np

BF16_FLOP_PER_S = 989.4e12
HBM_BYTES_PER_S = 3.35e12
WINDOW_TOKENS = 8


def active_matmul_params(m: dict) -> int:
    """Weights one token multiplies by, embeddings excluded: q, k, v, o, the
    FFN (for an expert layer the router, the top-k experts and the dense
    residual FFN), per layer, times the layers."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (m["n_heads"] + 2 * m["n_kv_heads"]) + m["n_heads"] * hd * d
    if m.get("n_experts"):
        ffn = m["top_k"] * 3 * d * m["expert_d_ff"] + d * m["n_experts"]
        ffn += 3 * d * m.get("dense_residual_ff", 0)
    else:
        ffn = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + ffn)


def row_flops(m: dict) -> float:
    """Model FLOPs of one missed query: 2 x the active weights x the 8 tokens
    of its window, plus the unembedding of the last position only (the back
    end scores only that one).  The attention scores over 8 positions, the
    norms and the padding rows are not counted."""
    return 2.0 * active_matmul_params(m) * WINDOW_TOKENS + 2.0 * m["d_model"] * m["vocab_size"]


def serve_call_bytes(bp: int, n_sets: int, ways: int, value_dim: int, n_fill: int,
                     n_rows_read: int) -> int:
    """Bytes one call of the fused serve kernel must move for a batch padded
    to ``bp`` requests that touches ``n_sets`` distinct sets, applies
    ``n_fill`` deferred value writes and gathers ``n_rows_read`` distinct
    value rows: each input read once, each output written once.

    Inputs: per request the two hash words, the set, the write epoch and the
    freshness floor (4 B each), the admit and static flags (1 B each); each
    deferred write's slot (4 B) and values; the touched set rows (4 W words
    of 4 B); the gathered value rows.  Outputs: the touched rows written
    back, the deferred values written, and per request the hit, stale and
    wrote flags (1 B each), the probed way, the write way and the resident
    epoch (4 B each) and its value row.  Padding requests' rows, and the
    rows a miss gathers, are not counted."""
    row = 4 * ways * 4
    vrow = value_dim * 4
    total = bp * (4 * 5 + 2)
    total += n_fill * (4 + 2 * vrow)
    total += 2 * n_sets * row
    total += n_rows_read * vrow
    total += bp * (3 + 12 + vrow)
    return int(total)


def pow2(n: int) -> int:
    """The next power of two (the broker's batch bucket, the back end's
    graph rows)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def distinct(a: np.ndarray) -> int:
    return int(len(np.unique(a)))
