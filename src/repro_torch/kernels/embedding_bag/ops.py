"""Public op: EmbeddingBag over ``(B, L)`` bags padded with -1.

``embedding_bag_op`` is the port of ``repro.kernels.embedding_bag.ops.
embedding_bag_op``.  The TPU op flattens the bags, appends a zero row to the
table for the pads (a copy of the table on every call) and hands the kernel
ascending segments; the CUDA kernel reads the ``(B, L)`` bags as they are
and skips the pads, so the op passes them through: on the card to the
kernel, on the CPU to the plain version.  ``use_kernel=False`` runs the
plain version on any device, as the JAX op's flag runs its oracle.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import embedding_bag_plain


def embedding_bag_op(
    table: torch.Tensor,  # (V, D) f32 or bf16
    bags: torch.Tensor,  # (B, L) int32 or int64, padded with -1
    mode: str = "sum",
    use_kernel: bool = True,
) -> torch.Tensor:
    """``(B, D)`` in the table's dtype: each bag's sum or mean of rows."""
    if not use_kernel:
        return embedding_bag_plain(table, bags, mode)
    return kernel.embedding_bag(table, bags.contiguous(), mode)
