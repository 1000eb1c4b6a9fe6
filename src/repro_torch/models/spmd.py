"""SPMD on a mesh by hand: what GSPMD and ``shard_map`` do for the
reference, for the port's models on DTensor inputs.

A step placed on a ``DeviceMesh`` gets DTensors: parameters as the sharding
rules place them at rest, batches sharded on their leading dim over the
batch axes.  Each rank then runs the model on local tensors:

* the batch is the rank's own rows (``Shard(0)`` over the batch dims of the
  mesh, :attr:`Spmd.batch_dims`), or all of it where it does not divide;
* a parameter is gathered whole where it is used (:func:`use`): ZeRO-3 over
  every axis it rests sharded on.  Its gradient is declared ``Partial`` over
  the batch dims (each rank saw its own rows) and whole over the others
  (every rank computed the same), so DTensor's backward reduce-scatters or
  all-reduces it into the placement it rests in;
* what is not batch-parallel is computed alike on every rank of the other
  axes.  The collectives below keep that invariant in the backward pass:
  :func:`sum_over` (all-reduce, backward identity), :func:`mean_over`,
  :func:`gather_over` (all-gather, backward the rank's own chunk),
  :func:`chunk_over` (the rank's chunk, backward all-gather),
  :func:`tp_enter` (identity, backward all-reduce: Megatron's ``f``) and
  :func:`gather_partial` (all-gather, backward reduce-scatter: for a
  consumer that differs by rank, as a dst-partitioned graph layer).

The exceptions are the shard-local paths: the MoE (experts gathered over
their FSDP axes per layer, the FFN tensor-parallel over ``model``), the
row-sharded embedding tables of the recsys models and the sharded KV cache
(``repro_torch.models.transformer``, ``repro_torch.kernels.embedding_bag``).

A collective over mesh dims of size 1 is skipped, so a mesh of one rank
runs the one-device code with no communication.  Several dims together act
as one group, the first dim major (the reference's tuple axes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .common import tree_leaves, tree_map, tree_map_with_path


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@dataclasses.dataclass(frozen=True)
class Spmd:
    """The mesh a step runs on and the mesh dims its batch is sharded over."""

    mesh: Any
    batch_dims: Tuple[int, ...]


def mesh_dims(mesh, axes: Sequence[str]) -> Tuple[int, ...]:
    names = tuple(mesh.mesh_dim_names)
    return tuple(names.index(a) for a in axes if a in names)


def group_size(mesh, dims: Sequence[int]) -> int:
    return math.prod(mesh.size(d) for d in dims)


def _live(mesh, dims: Sequence[int]) -> Tuple[int, ...]:
    return tuple(d for d in dims if mesh.size(d) > 1)


def rank_in(mesh, dims: Sequence[int]) -> int:
    """This rank's index in the group of ``dims``, the first dim major."""
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    layout, given to ``DTensor.from_local``)."""
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def sharded_dims(t, tensor_dim: int) -> Tuple[int, ...]:
    """The mesh dims over which DTensor ``t`` shards ``tensor_dim``."""
    from torch.distributed.tensor import Shard

    return tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == tensor_dim)


# ---------------------------------------------------------------------------
# Collectives on local tensors
# ---------------------------------------------------------------------------


def _all_reduce(x, mesh, dims):
    import torch.distributed._functional_collectives as fc

    for d in _live(mesh, dims):
        x = fc.wait_tensor(fc.all_reduce(x, "sum", (mesh, d)))
    return x


def _all_gather(x, mesh, dims, dim):
    import torch.distributed._functional_collectives as fc

    gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor  # newer name first
    for d in reversed(_live(mesh, dims)):  # minor first: chunks land in major order
        x = fc.wait_tensor(gather(x.contiguous(), dim, (mesh, d)))
    return x


def _reduce_scatter(x, mesh, dims, dim):
    import torch.distributed._functional_collectives as fc

    scatter = getattr(fc, "reduce_scatter_single", None) or fc.reduce_scatter_tensor
    for d in _live(mesh, dims):  # major first: the inverse of _all_gather
        x = fc.wait_tensor(scatter(x.contiguous(), "sum", dim, (mesh, d)))
    return x


def _chunk(x, mesh, dims, dim):
    n = group_size(mesh, dims)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, rank_in(mesh, dims) * size, size)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _TpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.dims), None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, dim, partial):
        ctx.mesh, ctx.dims, ctx.dim, ctx.partial = mesh, dims, dim, partial
        return _all_gather(x, mesh, dims, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _reduce_scatter(g, ctx.mesh, ctx.dims, ctx.dim)
        else:
            g = _chunk(g, ctx.mesh, ctx.dims, ctx.dim).contiguous()
        return g, None, None, None, None


class _ChunkOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, dim):
        ctx.mesh, ctx.dims, ctx.dim = mesh, dims, dim
        return _chunk(x, mesh, dims, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.dims, ctx.dim), None, None, None


def sum_over(x, mesh, dims):
    """All-reduce (sum) over ``dims``; the backward passes each rank's
    gradient through (the sum is consumed alike on every rank)."""
    return _SumOver.apply(x, mesh, tuple(dims)) if _live(mesh, dims) else x


def mean_over(x, mesh, dims):
    """The mean over ``dims`` of each rank's ``x``; the backward gives each
    rank 1/n of its gradient."""
    return sum_over(x, mesh, dims) / group_size(mesh, dims) if _live(mesh, dims) else x


def tp_enter(x, mesh, dims):
    """Identity; the backward all-reduces: the input of a tensor-parallel
    region whose ranks each see part of its gradient."""
    return _TpEnter.apply(x, mesh, tuple(dims)) if _live(mesh, dims) else x


def gather_over(x, mesh, dims, dim: int):
    """The ranks' chunks of ``dims`` concatenated along ``dim``; the
    backward keeps the rank's own chunk (the whole is consumed alike)."""
    return _GatherOver.apply(x, mesh, tuple(dims), dim, False) if _live(mesh, dims) else x


def gather_partial(x, mesh, dims, dim: int):
    """As :func:`gather_over`, but each rank's consumer differs: the
    backward reduce-scatters (sums every rank's gradient of each chunk)."""
    return _GatherOver.apply(x, mesh, tuple(dims), dim, True) if _live(mesh, dims) else x


def chunk_over(x, mesh, dims, dim: int):
    """The rank's chunk of ``x`` along ``dim`` over ``dims``; the backward
    all-gathers."""
    return _ChunkOver.apply(x, mesh, tuple(dims), dim) if _live(mesh, dims) else x


# ---------------------------------------------------------------------------
# DTensors to local tensors
# ---------------------------------------------------------------------------


def use(p, partial_dims: Sequence[int] = (), shard: Optional[dict] = None):
    """The local tensor a rank computes with: a DTensor gathered whole over
    every mesh dim but those ``shard`` maps to a tensor dim (``{mesh dim:
    tensor dim}``: the rank's chunk there).  Its gradient is ``Partial``
    over ``partial_dims`` (the mesh dims whose ranks saw different rows).
    A mesh dim of size 1 is left as it is (nothing to gather or split, so
    a mesh of one rank hands back the tensor itself).  A plain tensor is
    returned as it is."""
    if not is_dtensor(p):
        return p
    from torch.distributed.tensor import Partial, Replicate, Shard

    shard = shard or {}
    mesh = p.device_mesh
    target = [p.placements[d] if mesh.size(d) == 1 else
              (Shard(shard[d]) if d in shard else Replicate()) for d in range(mesh.ndim)]
    grad = [Partial() if d in partial_dims and mesh.size(d) > 1 else target[d]
            for d in range(mesh.ndim)]
    if tuple(target) != tuple(p.placements):
        p = p.redistribute(mesh, target)
    return p.to_local(grad_placements=grad)


def use_tree(tree, partial_dims: Sequence[int] = (),
             skip: Callable[[str], bool] = lambda path: False):
    """:func:`use` of every leaf whose path ``skip`` does not name (those
    stay DTensors, for a shard-local path to take)."""
    return tree_map_with_path(
        lambda path, leaf: leaf if skip(path) else use(leaf, partial_dims), tree)


def mesh_of(tree):
    """The mesh of the first DTensor leaf of ``tree``, or None."""
    for leaf in tree_leaves(tree):
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def enter(batch):
    """``(Spmd or None, local batch)``: the mesh of a batch (a DTensor or a
    dict of them), the mesh dims any of its leaves is sharded over (its
    rows: a batch, candidates), and the rank's blocks.  Plain tensors give
    ``None`` and come back as they are."""
    from torch.distributed.tensor import Shard

    dts = [t for t in tree_leaves(batch) if is_dtensor(t)]
    if not dts:
        return None, batch
    dims = sorted({i for t in dts for i, p in enumerate(t.placements) if isinstance(p, Shard)})
    local = tree_map(lambda t: t.to_local() if is_dtensor(t) else t, batch)
    return Spmd(dts[0].device_mesh, tuple(dims)), local


def leave(x, ctx: Optional[Spmd], replicated: bool = False):
    """A rank's local rows ``x`` as a DTensor sharded like the step's batch
    (or replicated); ``x`` itself when there is no mesh."""
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [Shard(0) if (d in ctx.batch_dims and not replicated) else Replicate()
          for d in range(ctx.mesh.ndim)]
    return DTensor.from_local(x, ctx.mesh, pl, run_check=False)


__all__ = [
    "Spmd",
    "chunk_over",
    "enter",
    "gather_over",
    "gather_partial",
    "group_size",
    "is_dtensor",
    "leave",
    "mean_over",
    "mesh_dims",
    "mesh_of",
    "rank_in",
    "sum_over",
    "tp_enter",
    "use",
    "use_tree",
]
