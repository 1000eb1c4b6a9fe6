"""Plain PyTorch versions of the embedding-bag kernel.

:func:`embedding_bag_plain` is the contract the CUDA kernel follows to the
bit, over ``(B, L)`` bags whose negative ids are pads:

* each bag's valid rows are summed in f32, slot by slot in the order
  ``l = 0 .. L-1``, pads skipped (an explicit loop: a ``.sum(dim=1)`` has no
  fixed order on the card);
* the sum is rounded to the table's dtype;
* ``mean`` divides that by ``max(count, 1)`` in f32 and rounds again;
* a bag that is all pads gives zeros;
* an id at or past ``V`` contributes NaN, as the reference's ``jnp.take``
  fills out-of-range rows.

It is differentiable with respect to the table: autograd's backward of
its one gather (``index_select``) is one ``index_add_`` of each slot's
gradient onto its row, pads and ids past ``V`` adding zero rows, the ids
in ``(B, L)`` row-major order (:func:`embedding_bag_backward` runs the
same ``index_add_`` directly).

On the CPU this equals ``repro.models.recsys.embedding_bag`` bit for bit
in f32 and bf16, and the JAX op ``embedding_bag_op`` bit for bit in f32
(its Pallas kernel adds rows in the table's dtype, so in bf16 it rounds
every add).  Used by the CPU tests, by ``device="cpu"``, and on the card
only to check the kernel against.

:func:`embedding_bag_ref` copies the reference's flat contract
(``repro.kernels.embedding_bag.ref.embedding_bag_ref``): row ids with
ascending bag ids, summed per bag.
"""
from __future__ import annotations

import torch

MODES = ("sum", "mean")


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` in f32 for ids in ``[0, V)``, NaN rows for ids past it
    (negative ids read row 0: the caller masks them)."""
    v = table.shape[0]
    rows = torch.index_select(table, 0, ids.clamp(0, max(v - 1, 0))).float()
    return torch.where((ids >= v)[:, None], torch.nan, rows)


def embedding_bag_plain(
    table: torch.Tensor,  # (V, D) f32 or bf16
    bags: torch.Tensor,  # (B, L) int32 or int64, negative ids are pads
    mode: str = "sum",
) -> torch.Tensor:
    """``(B, D)`` in the table's dtype: per bag, the sum (or mean) of the
    table rows its valid ids name."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, l = bags.shape
    valid = bags >= 0
    # one gather of every slot's row: autograd's backward of it is one
    # index_add_ over the (B, L) ids in row-major order
    rows = _rows(table, bags.reshape(-1)).reshape(b, l, table.shape[1])
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32, device=table.device)
    for j, row in enumerate(rows.unbind(1)):
        acc = torch.where(valid[:, j : j + 1], acc + row, acc)
    out = acc.to(table.dtype)
    if mode == "mean":
        count = valid.sum(dim=1, dtype=torch.int32).clamp(min=1).float()
        out = (out.float() / count[:, None]).to(table.dtype)
    return out


def embedding_bag_ref(
    table: torch.Tensor,  # (V, D)
    indices: torch.Tensor,  # (N,) row ids, sorted by bag
    segments: torch.Tensor,  # (N,) bag id per index, ascending
    n_bags: int,
    mode: str = "sum",
) -> torch.Tensor:
    """``(n_bags, D)``: per bag, the sum (or mean) of its rows, in the
    table's dtype; a bag with no index gives zeros."""
    rows = table[indices.long()]
    seg = segments.long()
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype, device=table.device)
    out.index_add_(0, seg, rows)
    if mode == "mean":
        count = torch.zeros(n_bags, dtype=table.dtype, device=table.device)
        count.index_add_(0, seg, torch.ones_like(seg, dtype=table.dtype))
        out = out / count.clamp(min=1.0)[:, None]
    return out


def embedding_bag_backward(
    grad: torch.Tensor,  # (B, D), the output's gradient
    bags: torch.Tensor,  # (B, L), negative ids are pads
    num_rows: int,
    mode: str = "sum",
) -> torch.Tensor:
    """``(V, D)`` in ``grad``'s dtype: the gradient of :func:`embedding_bag_plain`
    with respect to the table, which XLA derives from the reference's
    ``embedding_bag`` too.  Each valid id's row receives its bag's output
    gradient (divided in f32 by the bag's valid count in ``mean`` mode);
    pads and ids at or past ``V`` receive nothing.

    One ``index_add_`` into a zero table gradient of every slot in
    ``(B, L)`` row-major order, a pad or an out-of-range id adding a zero
    row to its clamped id: the scatter autograd runs for the plain
    version's ``index_select``, on the same inputs, so the two gradients
    are equal bit for bit wherever ``index_add_`` is deterministic (the
    CPU; the card under ``torch.use_deterministic_algorithms``, where it
    is a sorted scatter; by default it adds with atomics there)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, l = bags.shape
    valid = bags >= 0
    g = grad.float()
    if mode == "mean":
        count = valid.sum(dim=1, dtype=torch.int32).clamp(min=1).float()
        g = g / count[:, None]
    g = g.to(grad.dtype)
    keep = valid & (bags < num_rows)
    rows = torch.where(keep[..., None], g[:, None, :], 0).reshape(b * l, -1)
    out = torch.zeros((num_rows, grad.shape[1]), dtype=grad.dtype, device=grad.device)
    # the ids in the bags' dtype, as the plain version's gather takes them
    # (on the CPU a bf16 index_add_ with int32 ids sums in another order
    # than with int64 ones)
    ids = bags.reshape(-1).clamp(0, max(num_rows - 1, 0))
    return out.index_add_(0, ids, rows)
