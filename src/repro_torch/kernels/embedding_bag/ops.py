"""Public op: EmbeddingBag over ``(B, L)`` bags padded with -1.

``embedding_bag_op`` is the port of ``repro.kernels.embedding_bag.ops.
embedding_bag_op``.  The TPU op flattens the bags, appends a zero row to the
table for the pads (a copy of the table on every call) and hands the kernel
ascending segments; the CUDA kernel reads the ``(B, L)`` bags as they are
and skips the pads, so the op passes them through: on the card to the
kernel, on the CPU to the plain version.  ``use_kernel=False`` runs the
plain version on any device, as the JAX op's flag runs its oracle.

The op is differentiable with respect to the table.  The reference has no
backward kernel (no ``custom_vjp`` around its Pallas kernel; XLA derives
the gradient of the plain function as a scatter-add), so neither has the
port: with ``use_kernel=True`` a ``torch.autograd.Function`` runs the
kernel forward and :func:`~.ref.embedding_bag_backward` (PyTorch's
``index_add_`` into a zero table gradient) backward; ``use_kernel=False``
leaves the plain forward to autograd.  The backward runs the ``index_add_``
autograd derives for the plain version, on the same inputs, so the two
gradients are equal bit for bit where ``index_add_`` is deterministic (the
CPU, and the card under ``torch.use_deterministic_algorithms``).
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import embedding_bag_backward, embedding_bag_plain


class _EmbeddingBag(torch.autograd.Function):
    """The kernel forward, the table's gradient in PyTorch backward."""

    @staticmethod
    def forward(ctx, table, bags, mode):
        ctx.save_for_backward(bags)
        ctx.mode, ctx.num_rows = mode, table.shape[0]
        return kernel.embedding_bag(table, bags, mode)

    @staticmethod
    def backward(ctx, grad):
        (bags,) = ctx.saved_tensors
        return embedding_bag_backward(grad, bags, ctx.num_rows, ctx.mode), None, None


def embedding_bag_op(
    table: torch.Tensor,  # (V, D) f32 or bf16
    bags: torch.Tensor,  # (B, L) int32 or int64, padded with -1
    mode: str = "sum",
    use_kernel: bool = True,
) -> torch.Tensor:
    """``(B, D)`` in the table's dtype: each bag's sum or mean of rows."""
    if not use_kernel:
        return embedding_bag_plain(table, bags, mode)
    return _EmbeddingBag.apply(table, bags.contiguous(), mode)
