"""PNA (Principal Neighbourhood Aggregation) GNN [arXiv:2004.05718]: the
port of ``repro.models.gnn``.

Message passing is a gather of each edge's source row and a scatter of its
message into its destination node.  The reference's segment ops map to
torch's: a segment sum to ``index_add``, a segment max or min to
``scatter_reduce(..., "amax"/"amin", include_self=False)`` on a tensor of
-inf (+inf), whose empty segments the reference's ``where(isfinite)`` then
maps to 0.  (Started from zeros instead, torch's backward would count the
initial 0 as a tie of a max or min of 0, which the ReLU'd messages make
common; JAX splits a tied max's gradient evenly over the tied messages
only, and so does ``scatter_reduce`` on ±inf.)  PNA aggregates messages
with {mean, max, min, std} and rescales each by the degree scalers
{identity, amplification, attenuation}: 12 concatenated views.

**The sink.**  Edges padded into a fixed shape point at node ``n`` (one past
the last), or at -1 (:func:`partition_edges_by_dst`).  The gather reads
from ``h`` with one zero row appended and the scatters write into ``n + 1``
rows, then drop the last: a destination outside ``[0, n)`` lands in that
sink row and a source outside it reads the zero row.  The reference's
``jnp.take`` reads a NaN row for a source of ``n`` and wraps a source of
-1 to the last node; its segment ops drop a destination of ``n`` or -1.
So the padding conventions in use -- ``(n, n)`` for molecules, ``(0, n)``
and ``(0, -1)`` in training batches -- give the reference's values; the
reference's gradient through a ``(n, n)`` pad is NaN (ROADMAP.md, Queue 3),
the port's is finite.  No degree counts a pad edge.

Shape regimes, as in the reference:

* full-batch: one graph, a dense feature matrix and an edge index;
* sampled training: a block from the fanout sampler
  (:class:`NeighborSampler`);
* batched small graphs: ``(B, N, ...)`` padded molecules with masks
  (:func:`forward_batched`: the B graphs flattened into one, node ids
  offset by ``b * N``, so one gather and one scatter serve the batch where
  the reference vmaps).

Parameters are a plain dict (``{"encode", "layers": [{"msg", "upd"}],
"decode"}``, the reference's tree); :func:`params_from_numpy` carries the
JAX weights across for the tests.  :func:`forward_dist` is the vertex-cut
forward over a mesh (nodes sharded, dst-partitioned edges, one all-gather
per layer).  :func:`partition_edges_by_dst`, :class:`NeighborSampler` and
:func:`make_random_graph` are numpy copies of the reference's, with the
same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import spmd
from .common import tensor_from_numpy, tree_map, truncated_normal

Params = Any


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    n_layers: int = 4
    d_in: int = 128
    d_hidden: int = 75
    n_classes: int = 40
    #: mean log-degree of the training graph (PNA's amplification scaler)
    delta: float = 2.5
    dtype: Any = torch.float32

    @property
    def d_agg(self) -> int:
        return 4 * 3 * self.d_hidden  # aggregators x scalers x features


def init_params(generator: torch.Generator, cfg: PNAConfig) -> Params:
    """Seeded random weights on the generator's device with the
    reference's tree, shapes and scales (a truncated normal of std
    ``fan_in ** -0.5``)."""
    dev = generator.device

    def tn(shape, fan_in):
        return truncated_normal(shape, fan_in**-0.5, cfg.dtype, generator, dev)

    d = cfg.d_hidden
    layers = [{"msg": tn((d, d), d), "upd": tn((cfg.d_agg + d, d), cfg.d_agg + d)}
              for _ in range(cfg.n_layers)]
    return {
        "encode": tn((cfg.d_in, d), cfg.d_in),
        "layers": layers,
        "decode": tn((d, cfg.n_classes), d),
    }


def params_from_numpy(tree: Any, device="cuda") -> Params:
    """The port's parameters on ``device`` from the reference's tree of
    arrays (``jax.tree.map(np.asarray, params)``), bit for bit."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def _sink(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Node ids as int64, every id outside ``[0, n)`` mapped to the sink ``n``."""
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _pna_aggregate(msgs: torch.Tensor, dst: torch.Tensor, n_nodes: int, delta: float) -> torch.Tensor:
    """Messages (E, F) scattered to nodes: 4 aggregators x 3 degree scalers,
    (N, 12F).  Destinations outside ``[0, n_nodes)`` are dropped."""
    dst = _sink(dst, n_nodes)
    f = msgs.shape[1]
    rows = (n_nodes + 1, f)

    def seg_sum(x):
        return msgs.new_zeros(rows).index_add(0, dst, x)[:n_nodes]

    def seg_extreme(reduce, init):
        out = msgs.new_full(rows, init).scatter_reduce(
            0, dst[:, None].expand(-1, f), msgs, reduce, include_self=False)[:n_nodes]
        return torch.where(torch.isfinite(out), out, 0.0)

    deg = msgs.new_zeros(n_nodes + 1).index_add(0, dst, msgs.new_ones(dst.shape[0]))[:n_nodes]
    deg = deg.clamp(min=1.0)[:, None]
    mean = seg_sum(msgs) / deg
    mx = seg_extreme("amax", -float("inf"))
    mn = seg_extreme("amin", float("inf"))
    sq = seg_sum(msgs * msgs) / deg
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    std = torch.sqrt(torch.maximum(sq - mean * mean, msgs.new_tensor(1e-8)))
    agg = torch.cat([mean, mx, mn, std], dim=-1)  # (N, 4F)
    logd = torch.log1p(deg)
    amp = logd / delta
    att = delta / logd.clamp(min=1e-6)
    return torch.cat([agg, agg * amp, agg * att], dim=-1)  # (N, 12F)


def forward(
    params: Params,
    x: torch.Tensor,  # (N, d_in)
    edge_index: torch.Tensor,  # (2, E) [src; dst]
    cfg: PNAConfig,
    node_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-graph / mini-batch-block forward -> node logits (N, n_classes)."""
    n = x.shape[0]
    src, dst = _sink(edge_index[0], n), _sink(edge_index[1], n)
    h = x @ params["encode"].to(x.dtype)
    for layer in params["layers"]:
        h_pad = F.pad(h, (0, 0, 0, 1))  # the sink's zero row
        msgs = h_pad.index_select(0, src) @ layer["msg"].to(h.dtype)
        agg = _pna_aggregate(torch.relu(msgs), dst, n, cfg.delta)
        h_new = torch.cat([h, agg], dim=-1) @ layer["upd"].to(h.dtype)
        h = h + torch.relu(h_new)
    if node_mask is not None:
        h = h * node_mask[:, None].to(h.dtype)
    return h @ params["decode"].to(h.dtype)


def forward_batched(
    params: Params,
    x: torch.Tensor,  # (B, N, d_in) padded molecules
    edge_index: torch.Tensor,  # (B, 2, E) padded with index n (self-loop sink)
    node_mask: torch.Tensor,  # (B, N)
    cfg: PNAConfig,
) -> torch.Tensor:
    """Batched small graphs -> per-graph logits (B, n_classes) by masked
    mean pooling.  The B graphs run as one graph of B * N nodes: graph b's
    node ids are offset by ``b * N`` and its pad ids go to the batch's
    sink, so no message crosses graphs."""
    b, n, _ = x.shape
    off = torch.arange(b, device=x.device)[:, None, None] * n
    ei = edge_index.to(torch.int64)
    ei = torch.where((ei >= 0) & (ei < n), ei + off, b * n)  # (B, 2, E)
    flat = ei.permute(1, 0, 2).reshape(2, -1)
    node_logits = forward(params, x.reshape(b * n, -1), flat, cfg,
                          node_mask=node_mask.reshape(-1)).reshape(b, n, -1)
    denom = node_mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    return (node_logits * node_mask[..., None]).sum(dim=1) / denom


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: PNAConfig) -> torch.Tensor:
    """Node-classification cross-entropy over (optionally masked) nodes."""
    logits = forward(params, batch["x"], batch["edge_index"], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, batch["labels"].to(torch.int64)[:, None])[:, 0]
    mask = batch.get("label_mask")
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def forward_dist(params: Params, x: torch.Tensor, edge_index: torch.Tensor, cfg: PNAConfig,
                 mesh, batch_axes) -> torch.Tensor:
    """Vertex-cut PNA over ``mesh``: nodes sharded over ``batch_axes``, each
    shard owning the edges that point at its nodes (the layout of
    :func:`partition_edges_by_dst`), so every segment reduction is
    shard-local.  The one collective is an all-gather of the (N, d_hidden)
    features per layer; its backward reduce-scatters, since each shard's
    edges read the gathered rows differently.

    ``x`` (N, d_in) and ``edge_index`` (2, E) are DTensors sharded on N and
    E over the batch axes (the logits come back sharded so), or whole
    tensors, of which each rank takes its block (the logits come back
    whole).  Edges hold GLOBAL node ids; a shard maps its destinations to
    local ids and sends any outside its block to a sink row.  Parameters
    (plain or replicated DTensors) get gradients summed over the shards.
    Without batch axes on the mesh this is :func:`forward`."""
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    axes = tuple(a for a in batch_axes if a in names)
    if not axes:
        return forward(params, x, edge_index, cfg)
    dims = spmd.mesh_dims(mesh, axes)
    placed = spmd.is_dtensor(x)
    x_l = x.to_local() if placed else spmd._chunk(x, mesh, dims, 0)
    ei_l = edge_index.to_local() if spmd.is_dtensor(edge_index) else spmd._chunk(
        edge_index, mesh, dims, 1)
    params = spmd.use_tree(params, dims)
    n_local = x_l.shape[0]
    n = n_local * spmd.group_size(mesh, dims)
    src = _sink(ei_l[0], n)
    dst = ei_l[1].to(torch.int64) - spmd.rank_in(mesh, dims) * n_local  # outside: the sink
    h = x_l @ params["encode"].to(x_l.dtype)
    for layer in params["layers"]:
        h_full = F.pad(spmd.gather_partial(h, mesh, dims, 0), (0, 0, 0, 1))
        msgs = h_full.index_select(0, src) @ layer["msg"].to(h.dtype)
        agg = _pna_aggregate(torch.relu(msgs), dst, n_local, cfg.delta)
        h_new = torch.cat([h, agg], dim=-1) @ layer["upd"].to(h.dtype)
        h = h + torch.relu(h_new)
    out = h @ params["decode"].to(h.dtype)
    if placed:
        return spmd.leave(out, spmd.Spmd(mesh, dims))
    return spmd.gather_over(out, mesh, dims, 0)


# ---------------------------------------------------------------------------
# Host-side numpy: the edge partition, the neighbour sampler, random graphs
# ---------------------------------------------------------------------------


def partition_edges_by_dst(edge_index: np.ndarray, n_nodes: int, n_shards: int) -> np.ndarray:
    """Host-side layout contract for a destination-partitioned forward:
    shard i's equal-sized slice holds exactly the edges whose dst lives in
    node block i, padded with sink edges (src 0, dst -1)."""
    dst = edge_index[1]
    n_local = max(n_nodes // n_shards, 1)
    shard = np.minimum(dst // n_local, n_shards - 1)
    counts = np.bincount(shard, minlength=n_shards)
    m = int(counts.max())
    out = np.zeros((2, n_shards * m), dtype=np.int64)
    out[1] = -1  # sink padding
    for s in range(n_shards):
        sel = np.flatnonzero(shard == s)
        out[:, s * m : s * m + len(sel)] = edge_index[:, sel]
    return out


class NeighborSampler:
    """GraphSAGE-style fanout sampler over a CSR adjacency (host numpy)."""

    def __init__(self, n_nodes: int, edge_index: np.ndarray, seed: int = 0):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order].astype(np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample_block(self, seeds: np.ndarray, fanouts: Tuple[int, ...]):
        """Returns (block_nodes, block_edge_index, seed_positions).

        ``block_nodes`` are original node ids (seeds first); the edge index
        is relabeled into block-local ids, deduplicated per hop.
        """
        nodes = list(seeds.astype(np.int64))
        pos = {int(v): i for i, v in enumerate(nodes)}
        edges_src: list = []
        edges_dst: list = []
        frontier = seeds.astype(np.int64)
        for f in fanouts:
            next_frontier = []
            for v in frontier:
                lo, hi = self.offsets[v], self.offsets[v + 1]
                if hi == lo:
                    continue
                deg = hi - lo
                take = min(f, int(deg))
                picks = self.nbr[lo + self.rng.choice(deg, size=take, replace=False)]
                for u in picks:
                    u = int(u)
                    if u not in pos:
                        pos[u] = len(nodes)
                        nodes.append(u)
                        next_frontier.append(u)
                    edges_src.append(pos[u])
                    edges_dst.append(pos[int(v)])
            frontier = np.asarray(next_frontier, dtype=np.int64)
        block_nodes = np.asarray(nodes, dtype=np.int64)
        ei = np.stack(
            [
                np.asarray(edges_src, dtype=np.int64),
                np.asarray(edges_dst, dtype=np.int64),
            ]
        ) if edges_src else np.zeros((2, 0), dtype=np.int64)
        return block_nodes, ei, np.arange(len(seeds))


def make_random_graph(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int, seed: int = 0,
    power_law: bool = True,
) -> Dict[str, np.ndarray]:
    """Synthetic graph with power-law degrees (benchmark substrate).  At
    ``d_feat = 0`` no feature is drawn, and the labels come straight after
    the edges in the generator's stream."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = rng.zipf(1.3, size=n_nodes).astype(np.float64)
        p = w / w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=p)
    else:
        src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    x = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n_nodes)
    return {
        "x": x,
        "edge_index": np.stack([src, dst]).astype(np.int64),
        "labels": labels.astype(np.int64),
    }
