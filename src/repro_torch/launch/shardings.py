"""Parameter and activation sharding rules: the port of
``repro.launch.shardings`` (MaxText-style path-regex rules).

Weights shard over the "model" axis; batches shard over ("pod", "data").
Rules match flattened parameter paths; the first matching rule wins.  A
dimension is only sharded when divisible by the axis size -- otherwise the
rule falls back to replication for that dim, checked when the tree is
built.

A spec is a :class:`P`: a tuple with, per tensor dim, ``None``, an axis
name or a tuple of names, compared entry by entry as the reference's
``PartitionSpec``.  :func:`placements` turns one into DTensor placements
over a ``DeviceMesh``: ``Shard(d)`` on every mesh dim that names tensor
dim ``d``, ``Replicate()`` elsewhere.  A tuple of names shards one tensor
dim over several mesh dims, the first name major, as JAX lays it out: a
DTensor splits over its mesh dims in mesh order, so the names must come in
mesh order (every rule here does).  The functions take a ``DeviceMesh`` or
an :class:`~repro_torch.launch.mesh.AbstractMesh` (names and sizes).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Tuple

from ..models.common import tree_map_with_path
from .mesh import axis_names, axis_sizes, batch_axes


class P(tuple):
    """A partition spec: ``P("model", None)``; ``P()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def divisible_suffix(axes: Tuple[str, ...], dim: int, mesh) -> Tuple[str, ...]:
    """Longest suffix of ``axes`` (present in the mesh) whose product
    divides ``dim`` -- e.g. 16 experts over ("pod","data")=32 fall back to
    ("data",)=16.  The front axis (pod) is dropped first."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in axes if a in sizes)
    while axes:
        size = 1
        for a in axes:
            size *= sizes[a]
        if size > 1 and dim % size == 0:
            return axes
        axes = axes[1:]
    return ()


def _sanitize(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop axes missing from the mesh or not dividing the dimension."""
    names = axis_names(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts):
        if isinstance(axis, tuple):
            axis = divisible_suffix(axis, dim, mesh)
            axis = axis if len(axis) > 1 else (axis[0] if axis else None)
        elif axis is not None and axis not in names:
            axis = None
        size = _axis_size(mesh, axis)
        out.append(axis if size > 1 and dim % size == 0 else None)
    return P(*out)


# (path regex, spec) -- specs written for the *stacked* (L, ...) layer
# leaves produced by init_params.
LM_RULES: List[Tuple[str, P]] = [
    (r"embed$", P("model", None)),
    (r"lm_head$", P(None, "model")),
    (r"attn/q$", P(None, None, "model")),
    (r"attn/k$", P(None, None, "model")),
    (r"attn/v$", P(None, None, "model")),
    (r"attn/o$", P(None, "model", None)),
    (r"attn/._bias$", P(None, "model")),
    (r"(^|/)mlp/wi$", P(None, None, "model")),
    (r"(^|/)mlp/wo$", P(None, "model", None)),
    (r"moe/router$", P(None, None, None)),
    # stacked (L, E, D, 2, F): experts FSDP-shard over the batch axes (E),
    # the FFN hidden F is tensor-parallel over "model"
    (r"moe/wi$", P(None, ("pod", "data"), None, None, "model")),
    (r"moe/wo$", P(None, ("pod", "data"), "model", None)),
    (r".*", P()),  # norms, scalars
]

RECSYS_RULES: List[Tuple[str, P]] = [
    (r"(user|item)_table$", P("model", None)),
    (r"pos_table$", P()),
    (r".*tower.*/w$", P(None, "model")),
    (r".*", P()),
]

GNN_RULES: List[Tuple[str, P]] = [
    (r".*", P()),  # PNA params are tiny; replicate, shard the graph instead
]

FAMILY_RULES = {"lm": LM_RULES, "recsys": RECSYS_RULES, "gnn": GNN_RULES}


def path_of(key_path) -> str:
    """A tree path (a sequence of dict keys, list indices or field names)
    as the reference's ``a/b/0/c``."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in key_path)


def spec_for_path(path: str, shape: Tuple[int, ...], rules, mesh) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return _sanitize(spec, shape, mesh)
    return P()


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of tensor dim {d} must come in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``); its DTensor
    :attr:`placements` place a tensor with ``distribute_tensor``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of each rank's block of a tensor of ``shape``."""
        out = list(shape)
        for d, axis in enumerate(self.spec):
            size = _axis_size(self.mesh, axis)
            if out[d] % size:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axis} "
                                 f"({size})")
            out[d] //= size
        return tuple(out)


def _tree_specs(tree: Any, mesh, family: str) -> Any:
    rules = FAMILY_RULES[family]
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_for_path(path, tuple(leaf.shape), rules, mesh)),
        tree)


def param_shardings(abstract_params: Any, mesh, family: str) -> Any:
    """A :class:`NamedSharding` tree matching a parameter tree."""
    return _tree_specs(abstract_params, mesh, family)


def opt_state_shardings(abstract_opt: Any, param_shardings_tree: Any, mesh, family: str) -> Any:
    """Optimizer-state leaves by the same rules on their own paths
    (``mu/layers/attn/q`` shards as ``layers/attn/q``; a factored
    statistic's ``.../row`` matches no weight rule and replicates)."""
    return _tree_specs(abstract_opt, mesh, family)


def batch_spec(mesh, batch: int, rank: int) -> P:
    """Shard the leading batch dim over ("pod","data") when divisible."""
    axes = batch_axes(mesh)
    size = _axis_size(mesh, axes) if axes else 1
    if axes and batch % size == 0:
        lead = axes if len(axes) > 1 else axes[0]
        return P(lead, *([None] * (rank - 1)))
    return P(*([None] * rank))


def data_sharding(mesh, batch: int, rank: int) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh, batch, rank))


def kv_cache_spec(mesh, batch: int, seq: int, n_kv: int) -> P:
    """(L, B, S, n_kv, hd): shard batch over ("pod","data") when divisible,
    otherwise shard the sequence; sequence additionally shards over "model"
    (split-KV decode) when the kv-head dim cannot use it."""
    sizes = axis_sizes(mesh)
    axes = batch_axes(mesh)
    bsize = _axis_size(mesh, axes) if axes else 1
    msize = sizes.get("model", 1)
    kv_shardable = n_kv % msize == 0 and n_kv >= msize
    if batch % bsize == 0 and bsize > 1:
        b_axis = axes if len(axes) > 1 else axes[0]
        if kv_shardable:
            return P(None, b_axis, None, "model", None)
        if seq % msize == 0:
            return P(None, b_axis, "model", None, None)
        return P(None, b_axis, None, None, None)
    # batch unshardable (e.g. long_500k B=1): spread sequence over everything
    all_axes = tuple(axes) + (("model",) if msize > 1 else ())
    total = bsize * msize
    if seq % total == 0 and all_axes:
        return P(None, None, all_axes if len(all_axes) > 1 else all_axes[0], None, None)
    return P()


__all__ = [
    "FAMILY_RULES",
    "GNN_RULES",
    "LM_RULES",
    "NamedSharding",
    "P",
    "RECSYS_RULES",
    "batch_spec",
    "data_sharding",
    "divisible_suffix",
    "kv_cache_spec",
    "opt_state_shardings",
    "param_shardings",
    "path_of",
    "placements",
    "spec_for_path",
]
