"""Step builders of the LM, GNN and recsys families: the port of
``repro.launch.steps`` (``build_lm_step``, ``_lm_optimizer``,
``build_gnn_step``, ``_recsys_fns``, ``build_recsys_step``) on one device.

:func:`build_lm_step` gives the LM's ``train`` (loss, gradients, AdamW or
Adafactor as ``_lm_optimizer`` picks: Adafactor for the MoE archs),
``prefill`` and ``decode`` steps with the reference's ``model_flops``.  An
MoE arch's steps run its MoE on the one device, the function the
reference's shard-local MoE computes on a mesh of one device.  :func:`build_gnn_step` gives PNA's serve
step (``molecule``: padded molecules through ``forward_batched``) and its
train steps (node classification with AdamW) on a seeded batch at the
reference's padded sizes.  For each recsys architecture, the training
loss, the serve function (a batch of users or histories against one
target each) and the retrieval function (one query against
``n_candidates`` items), with makers of seeded batches of real ids at a
shape's sizes.  The reference's makers build ``ShapeDtypeStruct``s for its
dry-run; the port's draw data from a ``torch.Generator``:

* ids are uniform over the table they index;
* each multi-hot bag (two-tower's user and item features) has a length
  uniform in ``1 .. L``, its ids first and -1 pads after them;
* histories (SASRec, DIN, MIND) are full; DIN's labels are 0 or 1;
* graphs come from ``gnn.make_random_graph`` (and, for ``minibatch_lg``,
  a block of ``gnn.NeighborSampler``), seeded from the generator; node
  features are normals drawn by the generator on its device.

A train step updates the parameters and the optimizer state in place
(``repro_torch.train.optim``) and returns them with ``{"loss": loss}``.
No mesh and no sharding: they wait with ``shardings.py`` and ``mesh.py``
(ROADMAP.md, Queue 1 item 12), as do the reference's ``opts`` (perf
levers; the LM's ``decode_window_slice`` is a config field, set with
``dataclasses.replace``) and the GNN's ``dist_edges``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.registry import Arch, ShapeSpec
from ..core.device import resolve_device
from ..models import gnn, recsys, transformer
from ..models.common import tree_leaves, tree_map
from ..train import optim

#: two-tower's multi-hot bag lengths: user features and item features
_USER_BAG = 8
_ITEM_BAG = 4

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class BoundStep:
    """A step bound to its parameters, with its seeded batch."""

    #: ``fn(batch)`` -> outputs (scores, logits), or for ``train`` ->
    #: ``(params, opt_state, {"loss": loss})``, updating both in place;
    #: two-tower's also takes ``use_kernel``
    fn: Callable[..., Any]
    batch: Batch
    #: analytic model flops per call, the reference's
    model_flops: float = 0.0
    #: the AdamW state a ``train`` step updates (None otherwise)
    opt_state: Optional[optim.OptState] = None


def value_and_grad(loss_fn: Callable[..., torch.Tensor]):
    """``jax.value_and_grad`` over a tree of tensors: ``fn(params, *args,
    **kw)`` -> ``(loss, grads)``, the loss detached and the gradients a tree
    of ``params``' structure (zeros for a leaf the loss does not use).
    Turns on ``requires_grad`` of every leaf of ``params``."""
    def fn(params, *args, **kw):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, *args, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
        return loss.detach(), tree_map(lambda _: next(it), params)

    return fn


def _train_step(loss_fn, cfg, update, opt_cfg):
    """``step(params, opt_state, batch, **kw)``: loss, gradients, then
    ``update(params, grads, opt_state, opt_cfg)``, the reference's train
    step."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, batch, **kw):
        loss, grads = vg(params, batch, cfg, **kw)
        params, opt_state = update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss}

    return step


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMStep:
    name: str
    #: train: ``fn(params, opt_state, batch)`` -> ``(params, opt_state,
    #: {"loss": loss})``; prefill: ``fn(params, tokens)`` -> ``(logits,
    #: cache)``; decode: ``fn(params, cache, tokens)`` -> ``(logits, cache)``
    fn: Callable[..., Any]
    cfg: transformer.TransformerConfig
    #: (global_batch, seq_len) of the step's tokens (decode: one token
    #: against a seq_len cache)
    batch: int
    seq_len: int
    #: analytic model flops per call (6*N*D training / 2*N*D inference)
    model_flops: float
    #: "adamw" or "adafactor" (train)
    optimizer: str = "adamw"

    def init_opt_state(self, params):
        if self.optimizer == "adafactor":
            return optim.init_adafactor_state(params)
        return optim.init_opt_state(params)


def _lm_optimizer(arch: Arch) -> str:
    # 20B+ models keep only factored stats (see train/optim.py); smaller
    # dense models afford full AdamW moments.
    if arch.config.moe is not None or arch.config.param_count() > 2e10:
        return "adafactor"
    return "adamw"


def build_lm_step(arch: Arch, shape: ShapeSpec, smoke: bool = False) -> LMStep:
    """The ``train``, ``prefill`` or ``decode`` step of an LM ``arch`` at
    ``shape`` (seq_len <= 64 and batch <= 4 with ``smoke``, as the
    reference's).  The reference's ``opts`` (perf levers) and its MoE
    placement over the mesh's axes wait with the mesh."""
    if arch.family != "lm":
        raise ValueError(f"{arch.name} is not an LM architecture")
    cfg: transformer.TransformerConfig = arch.smoke_config if smoke else arch.config
    seq, gb = shape.dims["seq_len"], shape.dims["global_batch"]
    if smoke:
        seq, gb = min(seq, 64), min(gb, 4)
    optimizer = _lm_optimizer(arch)
    name = f"{arch.name}:{shape.name}:{shape.kind}"
    n_tokens = gb * seq
    if shape.kind == "train":
        if optimizer == "adafactor":
            fn = _train_step(transformer.loss_fn, cfg, optim.adafactor_updates,
                             optim.AdafactorConfig())
        else:
            fn = _train_step(transformer.loss_fn, cfg, optim.apply_updates, optim.AdamWConfig())
        return LMStep(name, fn, cfg, gb, seq, 6.0 * cfg.active_param_count() * n_tokens,
                      optimizer)
    if shape.kind == "prefill":
        def prefill(params, tokens):
            return transformer.prefill(params, tokens, cfg)

        return LMStep(name, prefill, cfg, gb, seq, 2.0 * cfg.active_param_count() * n_tokens,
                      optimizer)
    if shape.kind == "decode":
        def decode(params, cache, tokens):
            return transformer.decode_step(params, cache, tokens, cfg)

        return LMStep(name, decode, cfg, gb, seq, 2.0 * cfg.active_param_count() * gb,
                      optimizer)
    raise ValueError(f"unknown step kind {shape.kind!r}")


# ---------------------------------------------------------------------------
# GNN (PNA)
# ---------------------------------------------------------------------------

#: the reference pads node and edge counts to a multiple of this (one
#: device: no "pod" axis)
_GNN_PAD = 512
#: smoke: the reference's padded sizes, and the real graph inside them, so
#: the pad nodes and edges are exercised
_SMOKE_PADDED = (64, 256)
_SMOKE_GRAPH = (56, 240)
#: smoke: seeds of the minibatch_lg block (the graph's 56 nodes and 240
#: edges bound the block, so it fits the padded sizes)
_SMOKE_SEEDS = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np_seed(gen: torch.Generator) -> int:
    """A numpy seed drawn from ``gen`` (the host's graph draws follow it)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))


def _features(gen: torch.Generator, shape, real: torch.Tensor) -> torch.Tensor:
    """f32 normals of ``shape`` drawn on the generator's device, zero where
    ``real`` (broadcast over the last axis) is False."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x * real.to(x.device)[..., None]


def _node_batch(gen, n: int, e: int, d_feat: int, edge_index: np.ndarray, labels: np.ndarray,
                label_mask: np.ndarray) -> Batch:
    """A train batch padded to ``n`` nodes and ``e`` edges: pad edges ``(0,
    n)`` (source 0, destination the sink), pad nodes zero features, label 0,
    mask 0."""
    n_real, e_real = len(labels), edge_index.shape[1]
    if n_real > n or e_real > e:
        raise ValueError(f"a graph of {n_real} nodes and {e_real} edges exceeds the padded "
                         f"{n} and {e}")
    ei = np.zeros((2, e), np.int64)
    ei[1] = n
    ei[:, :e_real] = edge_index
    lab = np.zeros(n, np.int64)
    lab[:n_real] = labels
    mask = np.zeros(n, np.float32)
    mask[:n_real] = label_mask
    real = torch.arange(n) < n_real
    return {"x": _features(gen, (n, d_feat), real), "edge_index": torch.from_numpy(ei),
            "labels": torch.from_numpy(lab), "label_mask": torch.from_numpy(mask)}


def _molecule_batch(gen, b: int, n: int, e: int, d_feat: int) -> Batch:
    """``b`` padded molecules: each has a node count uniform in ``n // 2 ..
    n`` and an edge count uniform in its node count .. ``e``, the edges
    uniform over its nodes; pad edges are ``(n, n)``, the reference's
    self-loop sink, pad nodes have zero features and mask 0."""
    rng = np.random.default_rng(_np_seed(gen))
    n_real = rng.integers(n // 2, n + 1, size=b)
    e_real = rng.integers(n_real, e + 1)
    ei = (rng.random((b, 2, e)) * n_real[:, None, None]).astype(np.int64)
    ei[np.broadcast_to(np.arange(e)[None, None, :] >= e_real[:, None, None], ei.shape)] = n
    real = torch.from_numpy(np.arange(n)[None, :] < n_real[:, None])
    return {"x": _features(gen, (b, n, d_feat), real), "edge_index": torch.from_numpy(ei),
            "node_mask": real.to(torch.float32)}


def gnn_batch(arch: Arch, shape: ShapeSpec, generator: torch.Generator,
              smoke: bool = False) -> Batch:
    """A seeded batch of PNA's ``shape`` at the reference's sizes (with
    ``smoke``, its smoke sizes): ``molecule`` -> ``{"x", "edge_index",
    "node_mask"}``; the train shapes -> ``{"x", "edge_index", "labels",
    "label_mask"}`` padded to multiples of 512 (the reference's
    ``_round_up``).  Full-graph shapes are one ``make_random_graph`` graph,
    every node labelled; ``minibatch_lg`` is ``NeighborSampler``'s block of
    the shape's fanouts from ``batch_nodes`` seeds of such a graph, only
    the seeds labelled.  Features are drawn at ``cfg.d_in`` (as the
    reference's), on the generator's device; the rest on the CPU."""
    cfg = arch.smoke_config if smoke else arch.config
    dims = shape.dims
    if shape.name == "molecule":
        b = 8 if smoke else dims["batch"]
        return _molecule_batch(generator, b, dims["n_nodes"], dims["n_edges"], cfg.d_in)
    if smoke:
        (n, e), (n_g, e_g) = _SMOKE_PADDED, _SMOKE_GRAPH
    elif shape.name == "minibatch_lg":
        n, e = _round_up(dims["block_nodes"], _GNN_PAD), _round_up(dims["block_edges"], _GNN_PAD)
        n_g, e_g = dims["n_nodes"], dims["n_edges"]
    else:
        n_g, e_g = dims["n_nodes"], dims["n_edges"]
        n, e = _round_up(n_g, _GNN_PAD), _round_up(e_g, _GNN_PAD)
    seed = _np_seed(generator)
    graph = gnn.make_random_graph(n_g, e_g, 0, cfg.n_classes, seed=seed)
    if shape.name != "minibatch_lg":
        return _node_batch(generator, n, e, cfg.d_in, graph["edge_index"], graph["labels"],
                           np.ones(n_g, np.float32))
    n_seeds = _SMOKE_SEEDS if smoke else dims["batch_nodes"]
    seeds = np.random.default_rng(seed + 1).choice(n_g, size=n_seeds, replace=False)
    sampler = gnn.NeighborSampler(n_g, graph["edge_index"], seed=seed + 2)
    nodes, ei, seed_pos = sampler.sample_block(seeds, (dims["fanout0"], dims["fanout1"]))
    mask = np.zeros(len(nodes), np.float32)
    mask[seed_pos] = 1.0
    return _node_batch(generator, n, e, cfg.d_in, ei, graph["labels"][nodes], mask)


def gnn_model_flops(cfg: gnn.PNAConfig, shape: ShapeSpec, batch: Batch) -> float:
    """The reference's analytic flops of one call at ``batch``'s padded
    sizes: per graph, the edge messages' ``E d_h^2`` and the nodes' update
    ``N 13 d_h^2``, twice for multiply-add; a train step three times the
    forward over ``n_layers`` layers."""
    d = cfg.d_hidden
    if shape.kind == "serve":
        b, n, _ = batch["x"].shape
        return 2.0 * b * (batch["edge_index"].shape[2] * d**2 + n * (13 * d) * d)
    n, e = batch["x"].shape[0], batch["edge_index"].shape[1]
    return 2.0 * cfg.n_layers * (e * d**2 + n * (13 * d) * d) * 3


def build_gnn_step(arch: Arch, shape: ShapeSpec, params, generator: torch.Generator,
                   device="cuda", smoke: bool = False) -> BoundStep:
    """PNA's ``molecule`` serve step (``fn(batch)`` -> per-molecule logits
    ``(B, n_classes)``) or a train step (``fn(batch)`` -> ``(params,
    opt_state, {"loss": loss})``, AdamW with ``AdamWConfig()``) bound to
    ``params``, with a batch from :func:`gnn_batch` on ``device``."""
    dev = resolve_device(device)
    if arch.family != "gnn":
        raise ValueError(f"{arch.name} is not a GNN architecture")
    cfg: gnn.PNAConfig = arch.smoke_config if smoke else arch.config
    batch = {k: t.to(dev) for k, t in gnn_batch(arch, shape, generator, smoke).items()}
    flops = gnn_model_flops(cfg, shape, batch)
    if shape.kind == "serve":
        def serve(params, batch):
            return gnn.forward_batched(params, batch["x"], batch["edge_index"],
                                       batch["node_mask"], cfg)

        return BoundStep(functools.partial(serve, params), batch, model_flops=flops)
    if shape.kind != "train":
        raise ValueError(f"unknown step kind {shape.kind!r}")
    opt_state = optim.init_opt_state(params)
    step = _train_step(gnn.loss_fn, cfg, optim.apply_updates, optim.AdamWConfig())
    return BoundStep(functools.partial(step, params, opt_state), batch, model_flops=flops,
                     opt_state=opt_state)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------


def _ids(gen: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, device=gen.device, dtype=torch.int32)


def _bags(gen: torch.Generator, high: int, b: int, l: int) -> torch.Tensor:
    """(b, l) int32 bags: lengths uniform in 1..l, -1 pads after the ids."""
    ids = _ids(gen, high, (b, l))
    length = torch.randint(1, l + 1, (b, 1), generator=gen, device=gen.device)
    return torch.where(torch.arange(l, device=gen.device) < length, ids, -1)


def recsys_fns(arch: Arch, cfg):
    """``(serve_fn, retrieval_fn, make_serve, make_retr)`` per architecture:
    ``serve_fn(params, batch)`` and ``retrieval_fn(params, batch)`` as the
    reference's, and ``make_serve(b, generator)`` / ``make_retr(c,
    generator)`` draw a batch on the generator's device."""
    name = arch.name
    if name == "two-tower-retrieval":
        def make_serve(b, gen):
            return {"user_feats": _bags(gen, cfg.n_users, b, _USER_BAG),
                    "item_feats": _bags(gen, cfg.n_items, b, _ITEM_BAG)}

        def serve_fn(params, batch, use_kernel=True):
            u = recsys.two_tower_user(params, batch["user_feats"], cfg, use_kernel)
            i = recsys.two_tower_item(params, batch["item_feats"], cfg, use_kernel)
            return (u * i).sum(-1)

        def make_retr(c, gen):
            return {"user_feats": _bags(gen, cfg.n_users, 1, _USER_BAG),
                    "cand_feats": _bags(gen, cfg.n_items, c, _ITEM_BAG)}

        def retr_fn(params, batch, use_kernel=True):
            return recsys.two_tower_score_candidates(
                params, batch["user_feats"], batch["cand_feats"], cfg, use_kernel)

        return serve_fn, retr_fn, make_serve, make_retr

    if name == "sasrec":
        L = cfg.seq_len

        def make_serve(b, gen):
            return {"seq": _ids(gen, cfg.n_items, (b, L)),
                    "candidates": _ids(gen, cfg.n_items, (b, 1))}

        def serve_fn(params, batch):
            return recsys.sasrec_score(params, batch, cfg)[:, 0]

        def make_retr(c, gen):
            return {"seq": _ids(gen, cfg.n_items, (1, L)),
                    "candidates": _ids(gen, cfg.n_items, (1, c))}

        def retr_fn(params, batch):
            return recsys.sasrec_score(params, batch, cfg)[0]

        return serve_fn, retr_fn, make_serve, make_retr

    if name == "din":
        L = cfg.seq_len

        def make_serve(b, gen):
            return {"hist": _ids(gen, cfg.n_items, (b, L)),
                    "target": _ids(gen, cfg.n_items, (b,))}

        def serve_fn(params, batch):
            return recsys.din_forward(params, batch, cfg)

        def make_retr(c, gen):
            return {"hist": _ids(gen, cfg.n_items, (1, L)), "cands": _ids(gen, cfg.n_items, (c,))}

        def retr_fn(params, batch):
            hist = batch["hist"].expand(batch["cands"].shape[0], batch["hist"].shape[1])
            return recsys.din_forward(params, {"hist": hist, "target": batch["cands"]}, cfg)

        return serve_fn, retr_fn, make_serve, make_retr

    if name == "mind":
        L = cfg.seq_len

        def make_serve(b, gen):
            return {"seq": _ids(gen, cfg.n_items, (b, L)),
                    "candidates": _ids(gen, cfg.n_items, (b, 1))}

        def serve_fn(params, batch):
            return recsys.mind_score(params, batch, cfg)[:, 0]

        def make_retr(c, gen):
            return {"seq": _ids(gen, cfg.n_items, (1, L)),
                    "candidates": _ids(gen, cfg.n_items, (1, c))}

        def retr_fn(params, batch):
            return recsys.mind_score(params, batch, cfg)[0]

        return serve_fn, retr_fn, make_serve, make_retr

    raise ValueError(name)


def recsys_train_fns(arch: Arch, cfg):
    """``(loss_fn, make_train)``: the reference's training loss
    ``loss_fn(params, batch, cfg)`` and ``make_train(b, generator)``, which
    draws a training batch on the generator's device."""
    name = arch.name
    if name == "two-tower-retrieval":
        def make_train(b, gen):
            return {"user_feats": _bags(gen, cfg.n_users, b, _USER_BAG),
                    "item_feats": _bags(gen, cfg.n_items, b, _ITEM_BAG)}

        return recsys.two_tower_loss, make_train
    if name == "sasrec":
        def make_train(b, gen):
            return {"seq": _ids(gen, cfg.n_items, (b, cfg.seq_len)),
                    "pos_item": _ids(gen, cfg.n_items, (b,)),
                    "neg_item": _ids(gen, cfg.n_items, (b,))}

        return recsys.sasrec_loss, make_train
    if name == "din":
        def make_train(b, gen):
            return {"hist": _ids(gen, cfg.n_items, (b, cfg.seq_len)),
                    "target": _ids(gen, cfg.n_items, (b,)),
                    "label": _ids(gen, 2, (b,)).float()}

        return recsys.din_loss, make_train
    if name == "mind":
        def make_train(b, gen):
            return {"seq": _ids(gen, cfg.n_items, (b, cfg.seq_len)),
                    "candidates": _ids(gen, cfg.n_items, (b, 16))}

        return recsys.mind_loss, make_train
    raise ValueError(name)


RECSYS_INIT = {
    "two-tower-retrieval": recsys.init_two_tower,
    "sasrec": recsys.init_sasrec,
    "din": recsys.init_din,
    "mind": recsys.init_mind,
}


def build_recsys_step(arch: Arch, shape: ShapeSpec, params, generator: torch.Generator,
                      device="cuda", smoke: bool = False) -> BoundStep:
    """The ``train``, ``serve`` or ``retrieval`` step of ``arch`` at
    ``shape`` (batch 64 and 4096 candidates with ``smoke``, as the
    reference's smoke runs), bound to ``params`` (and for ``train`` to a
    fresh AdamW state, ``AdamWConfig()``), with a batch drawn from
    ``generator`` and moved to ``device``."""
    dev = resolve_device(device)
    if arch.family != "recsys":
        raise ValueError(f"{arch.name} is not a recsys architecture")
    cfg = arch.smoke_config if smoke else arch.config
    serve_fn, retr_fn, make_serve, make_retr = recsys_fns(arch, cfg)
    emb = cfg.embed_dim
    if shape.kind == "train":
        loss_fn, make_train = recsys_train_fns(arch, cfg)
        b = 64 if smoke else shape.dims["batch"]
        batch = {k: t.to(dev) for k, t in make_train(b, generator).items()}
        opt_state = optim.init_opt_state(params)
        step = _train_step(loss_fn, cfg, optim.apply_updates, optim.AdamWConfig())
        return BoundStep(functools.partial(step, params, opt_state), batch,
                          model_flops=6.0 * b * (2 * emb * 1024), opt_state=opt_state)
    if shape.kind == "serve":
        b = 64 if smoke else shape.dims["batch"]
        fn, batch, flops = serve_fn, make_serve(b, generator), 2.0 * b * (2 * emb * 1024)
    elif shape.kind == "retrieval":
        c = 4096 if smoke else shape.dims["n_candidates"]
        fn, batch, flops = retr_fn, make_retr(c, generator), 2.0 * c * emb
    else:
        raise ValueError(f"unknown step kind {shape.kind!r}")
    batch = {k: t.to(dev) for k, t in batch.items()}
    return BoundStep(functools.partial(fn, params), batch, model_flops=flops)
