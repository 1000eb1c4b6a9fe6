"""Step builders of the LM, GNN and recsys families: the port of
``repro.launch.steps`` (``StepBundle``, ``build_step``, ``input_specs``,
``build_lm_step``, ``_lm_optimizer``, ``build_gnn_step``, ``_recsys_fns``,
``build_recsys_step``).

:func:`build_step` ``(arch, shape, mesh, smoke, opts)`` gives the
reference's :class:`StepBundle`: the step function, its abstract inputs as
``meta`` tensors of the reference's shapes and dtypes (no weight is
allocated: arctic's ~960 GB tree included), trees of
:class:`~repro_torch.launch.shardings.NamedSharding` (DTensor placements)
for the inputs and outputs, ``model_flops`` and ``donate``.  ``jitted()``
places whole inputs by the in-shardings and runs the step on the mesh
(:mod:`repro_torch.models.spmd`); with ``mesh=None`` nothing is placed.
The reference's ``opts`` (perf levers) are handled as it handles them
(:func:`lm_config`); ``dist_edges`` on the GNN goes through
``gnn.forward_dist``.

:func:`build_lm_step` gives the LM's ``train`` (loss, gradients, AdamW or
Adafactor as ``_lm_optimizer`` picks: Adafactor for the MoE archs),
``prefill`` and ``decode`` steps with the reference's ``model_flops``, on
one device or, given a mesh, on DTensors.  :func:`build_gnn_step` gives
PNA's serve step (``molecule``: padded molecules through
``forward_batched``) and its train steps (node classification with AdamW)
bound to weights, on a seeded batch at the reference's padded sizes.  For
each recsys architecture, the training loss, the serve function (a batch
of users or histories against one target each) and the retrieval function
(one query against ``n_candidates`` items), with makers of seeded batches
of real ids at a shape's sizes.  The reference's makers build
``ShapeDtypeStruct``s for its dry-run; the port's draw data from a
``torch.Generator`` (on ``meta``, the bundle's abstract batches):

* ids are uniform over the table they index;
* each multi-hot bag (two-tower's user and item features) has a length
  uniform in ``1 .. L``, its ids first and -1 pads after them;
* histories (SASRec, DIN, MIND) are full; DIN's labels are 0 or 1;
* graphs come from ``gnn.make_random_graph`` (and, for ``minibatch_lg``,
  a block of ``gnn.NeighborSampler``), seeded from the generator; node
  features are normals drawn by the generator on its device.

A train step updates the parameters and the optimizer state in place
(``repro_torch.train.optim``; on DTensors :func:`mesh_update`) and returns
them with ``{"loss": loss}``.  The reference's ``lower()`` (XLA's
lowering) has no torch counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.registry import Arch, ShapeSpec
from ..core.device import resolve_device
from ..models import gnn, recsys, spmd, transformer
from ..models.common import meta_init, tree_leaves, tree_map
from ..train import optim
from .mesh import axis_names, batch_axes
from .shardings import (NamedSharding, P, batch_spec, divisible_suffix, kv_cache_spec,
                        opt_state_shardings, param_shardings)

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
    step (on DTensors, :func:`mesh_update`)."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, batch, **kw):
        loss, grads = vg(params, batch, cfg, **kw)
        params, opt_state = mesh_update(update, params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss}

    return step


def _local(t):
    return t.to_local() if spmd.is_dtensor(t) else t


def _clip(grads, clip_norm: float) -> None:
    """The reference's global-norm clip of DTensor gradients, in place: each
    leaf's sum of squares over its block, summed over the mesh dims it is
    sharded on, added in tree order (as ``global_norm`` on one device)."""
    from torch.distributed.tensor import Shard

    total = 0
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(_local(g).float()))
        if spmd.is_dtensor(g):
            dims = [i for i, p in enumerate(g.placements) if isinstance(p, Shard)]
            sq = spmd._all_reduce(sq, g.device_mesh, dims)
        total = total + sq
    scale = torch.clamp(clip_norm / torch.clamp(torch.sqrt(total), min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        _local(g).mul_(scale.to(g.dtype))


@torch.no_grad()
def mesh_update(update, params, grads, state, cfg):
    """``update(params, grads, state, cfg)`` (AdamW's or Adafactor's, in
    place) on plain tensors or DTensors.  AdamW's moments rest sharded as
    their parameters, so each rank updates its blocks, after the global
    clip (:func:`_clip`).  Adafactor's factored statistics rest replicated
    (the reference's rules), so each leaf's gradient and parameter are
    gathered whole, updated on every rank alike, and the rank keeps its
    block of the parameter."""
    if not any(spmd.is_dtensor(p) for p in tree_leaves(params)):
        return update(params, grads, state, cfg)
    # a gradient may come back Partial (DTensor defers the reduction): reduce
    # it into its parameter's placement first
    grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                     if spmd.is_dtensor(g) and g.placements != p.placements else g, grads, params)
    if update is optim.apply_updates:
        if cfg.clip_norm is not None:
            _clip(grads, cfg.clip_norm)
        local = lambda t: tree_map(_local, t)  # noqa: E731
        update(local(params), local(grads), optim.OptState(_local(state.step), local(state.mu),
                                                          local(state.nu)),
               dataclasses.replace(cfg, clip_norm=None))
        return params, state
    if update is not optim.adafactor_updates:
        raise ValueError(f"no mesh update for {update}")
    step = _local(state.step)
    for p, g, st in zip(tree_leaves(params), tree_leaves(grads), _stats_leaves(state)):
        whole = spmd.use(p).clone()
        optim.adafactor_updates({"p": whole}, {"p": spmd.use(g)},
                                optim.FactoredState(step.clone(), {"p": tree_map(_local, st)}), cfg)
        _local(p).copy_(_block(whole, p))
    step.add_(1)
    return params, state


def _stats_leaves(state) -> list:
    """Adafactor's per-leaf statistic dicts, in the parameters' leaf order."""
    out = []

    def walk(t):
        if isinstance(t, dict) and ("row" in t or "full" in t):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(state.stats)
    return out


def _block(whole: torch.Tensor, like) -> torch.Tensor:
    """The rank's block of ``whole`` as DTensor ``like`` rests."""
    if not spmd.is_dtensor(like):
        return whole
    from torch.distributed.tensor import DTensor, Replicate

    dt = DTensor.from_local(whole, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                            run_check=False)
    return dt.redistribute(like.device_mesh, like.placements).to_local()


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


def lm_config(arch: Arch, smoke: bool = False, mesh=None, opts: Optional[dict] = None):
    """The config an LM step runs, with the reference's ``opts`` handling:
    ``decode_window_slice`` forces ``scan_layers=False``; ``act_seq_axis``
    on a dense model sets ``moe_batch_axes`` to the batch axes; an MoE arch
    on a mesh gets ``moe_batch_axes``, ``moe_tp_axis="model"`` and
    ``moe_fsdp_axes`` (the batch axes' longest suffix dividing its
    experts).  A mesh is also set as the transformer's mesh handle."""
    cfg: transformer.TransformerConfig = arch.smoke_config if smoke else arch.config
    if mesh is not None:
        transformer.set_moe_mesh(mesh)
    if opts:
        if opts.get("decode_window_slice"):
            opts = dict(opts, scan_layers=False)
        if opts.get("act_seq_axis"):
            if mesh is None:
                raise ValueError("act_seq_axis shards the residual over a mesh axis: pass a mesh")
            if cfg.moe is None:
                opts = dict(opts, moe_batch_axes=batch_axes(mesh) or ("data",))
        cfg = dataclasses.replace(cfg, **opts)
    if cfg.moe is not None and mesh is not None:
        baxes = batch_axes(mesh) or ("data",)
        cfg = dataclasses.replace(
            cfg, moe_batch_axes=baxes,
            moe_tp_axis="model" if "model" in axis_names(mesh) else None,
            moe_fsdp_axes=divisible_suffix(baxes, cfg.moe.n_experts, mesh))
    return cfg


def build_lm_step(arch: Arch, shape: ShapeSpec, smoke: bool = False, mesh=None,
                  opts: Optional[dict] = None) -> LMStep:
    """The ``train``, ``prefill`` or ``decode`` step of an LM ``arch`` at
    ``shape`` (seq_len <= 64 and batch <= 4 with ``smoke``, as the
    reference's), its config by :func:`lm_config`.  Its ``fn`` takes plain
    tensors (one device) or DTensors placed on ``mesh`` (:func:`build_step`
    places them)."""
    if arch.family != "lm":
        raise ValueError(f"{arch.name} is not an LM architecture")
    cfg = lm_config(arch, smoke, mesh, opts)
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
                   device="cuda", smoke: bool = False, mesh=None,
                   opts: Optional[dict] = None) -> BoundStep:
    """PNA's ``molecule`` serve step (``fn(batch)`` -> per-molecule logits
    ``(B, n_classes)``) or a train step (``fn(batch)`` -> ``(params,
    opt_state, {"loss": loss})``, AdamW with ``AdamWConfig()``) bound to
    ``params``, with a batch from :func:`gnn_batch` on ``device``: the
    function of :func:`build_step`'s bundle, placed on ``mesh`` when one is
    given, ``opts`` (``dist_edges``) as the reference handles them."""
    dev = resolve_device(device)
    if arch.family != "gnn":
        raise ValueError(f"{arch.name} is not a GNN architecture")
    if shape.kind not in ("serve", "train"):
        raise ValueError(f"unknown step kind {shape.kind!r}")
    cfg: gnn.PNAConfig = arch.smoke_config if smoke else arch.config
    batch = {k: t.to(dev) for k, t in gnn_batch(arch, shape, generator, smoke).items()}
    flops = gnn_model_flops(cfg, shape, batch)
    run = build_step(arch, shape, mesh, smoke, opts).jitted()
    if shape.kind == "serve":
        return BoundStep(functools.partial(run, params), batch, model_flops=flops)
    opt_state = optim.init_opt_state(params)
    return BoundStep(functools.partial(run, params, opt_state), batch, model_flops=flops,
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
                      device="cuda", smoke: bool = False, mesh=None) -> BoundStep:
    """The ``train``, ``serve`` or ``retrieval`` step of ``arch`` at
    ``shape`` (batch 64 and 4096 candidates with ``smoke``, as the
    reference's smoke runs), bound to ``params`` (and for ``train`` to a
    fresh AdamW state, ``AdamWConfig()``), with a batch drawn from
    ``generator`` and moved to ``device``: the function of
    :func:`build_step`'s bundle, placed on ``mesh`` when one is given."""
    dev = resolve_device(device)
    if arch.family != "recsys":
        raise ValueError(f"{arch.name} is not a recsys architecture")
    if shape.kind not in ("train", "serve", "retrieval"):
        raise ValueError(f"unknown step kind {shape.kind!r}")
    cfg = arch.smoke_config if smoke else arch.config
    _, _, make_serve, make_retr = recsys_fns(arch, cfg)
    emb = cfg.embed_dim
    if shape.kind == "train":
        b = 64 if smoke else shape.dims["batch"]
        batch, flops = recsys_train_fns(arch, cfg)[1](b, generator), 6.0 * b * (2 * emb * 1024)
    elif shape.kind == "serve":
        b = 64 if smoke else shape.dims["batch"]
        batch, flops = make_serve(b, generator), 2.0 * b * (2 * emb * 1024)
    else:
        c = 4096 if smoke else shape.dims["n_candidates"]
        batch, flops = make_retr(c, generator), 2.0 * c * emb
    batch = {k: t.to(dev) for k, t in batch.items()}
    run = build_step(arch, shape, mesh, smoke).jitted()
    if shape.kind != "train":
        return BoundStep(functools.partial(run, params), batch, model_flops=flops)
    opt_state = optim.init_opt_state(params)
    return BoundStep(functools.partial(run, params, opt_state), batch, model_flops=flops,
                     opt_state=opt_state)


# ---------------------------------------------------------------------------
# Mesh-placed steps: StepBundle, build_step, input_specs
# ---------------------------------------------------------------------------


def place(t: torch.Tensor, sharding: Optional[NamedSharding]):
    """The rank's block of the whole tensor ``t`` as a DTensor placed by
    ``sharding`` (a view where it can be: no copy, no communication; on a
    mesh of one rank the tensor itself); ``t`` when ``sharding`` is None."""
    if sharding is None:
        return t
    from torch.distributed.tensor import DTensor, Shard

    sharding.shard_shape(t.shape)  # raises where a sharded dim does not divide
    mesh, local = sharding.mesh, t
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard) and mesh.size(i) > 1:
            size = local.shape[p.dim] // mesh.size(i)
            local = local.narrow(p.dim, mesh.get_local_rank(i) * size, size)
    return DTensor.from_local(local, mesh, sharding.placements, shape=t.shape,
                              stride=spmd.strides(t.shape), run_check=False)


def place_tree(tree, shardings):
    """:func:`place` over a tree and its tree of shardings (None: as is)."""
    if shardings is None:
        return tree
    return tree_map(place, tree, shardings)


@dataclasses.dataclass
class StepBundle:
    """The reference's ``StepBundle``: a step function, its abstract inputs
    (trees of ``meta`` tensors of the reference's shapes and dtypes), and
    trees of :class:`~repro_torch.launch.shardings.NamedSharding` for the
    inputs and outputs (their ``placements`` are DTensor placements; None
    without a mesh).  ``jitted()`` is the runnable step: it places whole
    inputs by ``in_shardings`` and runs ``fn``.  The reference's ``lower()``
    (XLA's lowering) has no counterpart."""

    name: str
    fn: Callable
    #: abstract inputs (tuple of trees of meta tensors)
    inputs: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    #: analytic model flops per invocation (6*N*D training / 2*N*D
    #: inference per token), for the roofline's "useful compute" ratio
    model_flops: float = 0.0
    #: the reference's donated argument indices (the KV cache, which the
    #: port's decode step updates in place; its train steps update the
    #: parameters and optimizer state in place too)
    donate: Tuple[int, ...] = ()

    def place(self, *args):
        """Each argument (a whole tree) placed by its ``in_shardings``."""
        return tuple(place_tree(a, sh) for a, sh in zip(args, self.in_shardings))

    def jitted(self):
        def step(*args, **kw):
            return self.fn(*self.place(*args), **kw)

        return step


def _named(mesh, spec: P):
    return NamedSharding(mesh, spec) if mesh is not None else None


def _shardings(tree, mesh, spec_of):
    """A tree of shardings, ``spec_of(leaf)`` each (None without a mesh)."""
    if mesh is None:
        return None
    return tree_map(lambda leaf: NamedSharding(mesh, spec_of(leaf)), tree)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def _meta_batch(maker, n: int):
    """A batch maker's ``maker(n, generator)`` batch on ``meta``."""
    return meta_init(lambda gen: maker(n, gen))


def _opt_shardings(a_opt, p_sh, mesh, family):
    return opt_state_shardings(a_opt, p_sh, mesh, family) if mesh is not None else None


def _build_lm(arch: Arch, shape: ShapeSpec, mesh, smoke: bool, opts) -> StepBundle:
    step = build_lm_step(arch, shape, smoke, mesh=mesh, opts=opts)
    cfg, gb, seq = step.cfg, step.batch, step.seq_len
    a_params = transformer.abstract_params(cfg)
    p_sh = param_shardings(a_params, mesh, "lm") if mesh is not None else None
    if shape.kind == "train":
        a_opt = step.init_opt_state(a_params)
        o_sh = _opt_shardings(a_opt, p_sh, mesh, "lm")
        batch = {"tokens": _meta((gb, seq), torch.int32)}
        b_sh = {"tokens": _named(mesh, batch_spec(mesh, gb, 2))} if mesh is not None else None
        return StepBundle(step.name, step.fn, (a_params.tree(), a_opt, batch), (p_sh, o_sh, b_sh),
                          (p_sh, o_sh, {"loss": _named(mesh, P())}), step.model_flops)
    kv = kv_cache_spec(mesh, gb, seq, cfg.n_kv_heads) if mesh is not None else None
    cache_sh = ({"k": _named(mesh, kv), "v": _named(mesh, kv), "len": _named(mesh, P())}
                if mesh is not None else None)
    t_sh = _named(mesh, batch_spec(mesh, gb, 2)) if mesh is not None else None
    logits_sh = t_sh
    if shape.kind == "prefill":
        def prefill(params, tokens):
            logits, cache = step.fn(params, tokens)
            if cache_sh is not None:
                cache = {k: v.redistribute(mesh, cache_sh[k].placements) for k, v in cache.items()}
            return logits, cache

        return StepBundle(step.name, prefill, (a_params.tree(), _meta((gb, seq), torch.int32)),
                          (p_sh, t_sh), (logits_sh, cache_sh), step.model_flops)
    kv_shape = (cfg.n_layers, gb, seq, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": _meta(kv_shape, cfg.dtype), "v": _meta(kv_shape, cfg.dtype),
             "len": _meta((), torch.int32)}
    return StepBundle(step.name, step.fn, (a_params.tree(), cache, _meta((gb, 1), torch.int32)),
                      (p_sh, cache_sh, t_sh), (logits_sh, cache_sh), step.model_flops,
                      donate=(1,))


def _use_params(params, ctx, row_tables: bool = False):
    """A step's parameters for the rank's compute (:func:`~.spmd.use`),
    two-tower's tables as :class:`~repro_torch.models.recsys.RowShard`."""
    is_table = (lambda path: path.endswith("_table")) if row_tables else (lambda path: False)
    local = spmd.use_tree(params, ctx.batch_dims, skip=is_table)
    if row_tables:
        for k in ("user_table", "item_table"):
            local[k] = recsys.row_shard(local[k], ctx.batch_dims)
    return local


def _on_rows(fn, row_tables: bool = False):
    """``fn(params, batch, **kw)`` on the rank's rows of a placed batch, its
    output sharded like them; plain inputs pass through."""
    def step(params, batch, **kw):
        ctx, local = spmd.enter(batch)
        if ctx is None:
            return fn(params, batch, **kw)
        return spmd.leave(fn(_use_params(params, ctx, row_tables), local, **kw), ctx)

    return step


def _rows_loss(loss_fn, row_tables: bool = False, own_mean: bool = False):
    """A per-example mean loss on the rank's rows, averaged over the ranks
    (``own_mean``: the loss averages itself, given the step's ``ctx``)."""
    def loss(params, batch, cfg, **kw):
        ctx, local = spmd.enter(batch)
        if ctx is None:
            return loss_fn(params, batch, cfg, **kw)
        p = _use_params(params, ctx, row_tables)
        if own_mean:
            return loss_fn(p, local, cfg, ctx=ctx, **kw)
        return spmd.mean_over(loss_fn(p, local, cfg, **kw), ctx.mesh, ctx.batch_dims)

    return loss


def _whole_loss(loss_fn):
    """A loss that needs the whole batch (a full graph's messages cross
    the node shards): the batch gathered, computed alike on every rank."""
    def loss(params, batch, cfg):
        if not any(spmd.is_dtensor(t) for t in tree_leaves(batch)):
            return loss_fn(params, batch, cfg)
        return loss_fn(spmd.use_tree(params), tree_map(spmd.use, batch), cfg)

    return loss


def _dist_loss(mesh, baxes):
    """The reference's ``loss_dist``: masked node cross-entropy over
    ``forward_dist``'s logits, the masked sums added over the node shards."""
    def loss(params, batch, cfg):
        logits = gnn.forward_dist(params, batch["x"], batch["edge_index"], cfg, mesh, baxes)
        ctx, local = spmd.enter({"labels": batch["labels"], "label_mask": batch["label_mask"]})
        logits = _local(logits)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, local["labels"].to(torch.int64)[:, None])[:, 0]
        num, den = (nll * local["label_mask"]).sum(), local["label_mask"].sum()
        if ctx is not None:
            num = spmd.sum_over(num, ctx.mesh, ctx.batch_dims)
            den = spmd.sum_over(den, ctx.mesh, ctx.batch_dims)
        return num / den.clamp(min=1.0)

    return loss


def _build_gnn(arch: Arch, shape: ShapeSpec, mesh, smoke: bool, opts) -> StepBundle:
    cfg: gnn.PNAConfig = arch.smoke_config if smoke else arch.config
    dist = bool(opts and opts.get("dist_edges"))
    dims = dict(shape.dims)
    a_params = meta_init(gnn.init_params, cfg)
    p_sh = _shardings(a_params, mesh, lambda leaf: P())
    opt_cfg = optim.AdamWConfig()
    a_opt = optim.init_opt_state(a_params)
    opt_sh = _shardings(a_opt, mesh, lambda leaf: P())
    pad = 1024 if mesh is not None and "pod" in axis_names(mesh) else _GNN_PAD

    def bs(n, rank):
        return _named(mesh, batch_spec(mesh, n, rank)) if mesh is not None else None

    if shape.name == "molecule":
        b = 8 if smoke else dims["batch"]
        n, e = dims["n_nodes"], dims["n_edges"]

        def serve(params, batch):
            return gnn.forward_batched(params, batch["x"], batch["edge_index"],
                                       batch["node_mask"], cfg)

        batch = {"x": _meta((b, n, cfg.d_in), torch.float32),
                 "edge_index": _meta((b, 2, e), torch.int32),
                 "node_mask": _meta((b, n), torch.float32)}
        b_sh = ({"x": bs(b, 3), "edge_index": bs(b, 3), "node_mask": bs(b, 2)}
                if mesh is not None else None)
        flops = 2.0 * b * (e * cfg.d_hidden**2 + n * (13 * cfg.d_hidden) * cfg.d_hidden)
        return StepBundle(f"{arch.name}:{shape.name}:serve", _on_rows(serve), (a_params, batch),
                          (p_sh, b_sh), bs(b, 2), flops)
    if shape.name == "minibatch_lg":
        n, e = dims["block_nodes"], dims["block_edges"]
    else:
        n, e = dims["n_nodes"], dims["n_edges"]
    if smoke:
        n, e = _SMOKE_PADDED
    else:
        n, e = _round_up(n, pad), _round_up(e, pad)
    if dist:
        loss = _dist_loss(mesh, batch_axes(mesh) if mesh is not None else ())
    else:
        loss = _whole_loss(gnn.loss_fn)
    step = _train_step(loss, cfg, optim.apply_updates, opt_cfg)
    batch = {"x": _meta((n, cfg.d_in), torch.float32), "edge_index": _meta((2, e), torch.int32),
             "labels": _meta((n,), torch.int32), "label_mask": _meta((n,), torch.float32)}
    b_sh = None
    if mesh is not None:
        node_spec = batch_spec(mesh, n, 2)
        edge_spec = P(None, node_spec[0]) if node_spec[0] is not None else P()
        b_sh = {"x": _named(mesh, node_spec), "edge_index": _named(mesh, edge_spec),
                "labels": bs(n, 1), "label_mask": bs(n, 1)}
    flops = 2.0 * cfg.n_layers * (e * cfg.d_hidden**2 + n * (13 * cfg.d_hidden) * cfg.d_hidden) * 3
    return StepBundle(f"{arch.name}:{shape.name}:train", step, (a_params, a_opt, batch),
                      (p_sh, opt_sh, b_sh), (p_sh, opt_sh, {"loss": _named(mesh, P())}), flops)


def _build_recsys(arch: Arch, shape: ShapeSpec, mesh, smoke: bool) -> StepBundle:
    cfg = arch.smoke_config if smoke else arch.config
    a_params = meta_init(RECSYS_INIT[arch.name], cfg)
    p_sh = param_shardings(a_params, mesh, "recsys") if mesh is not None else None
    serve_fn, retr_fn, make_serve, make_retr = recsys_fns(arch, cfg)
    dims, emb = shape.dims, cfg.embed_dim
    two_tower = arch.name == "two-tower-retrieval"

    def b_shardings(batch, b):
        return _shardings(batch, mesh, lambda leaf: batch_spec(mesh, b, leaf.dim()))

    if shape.kind == "train":
        b = 64 if smoke else dims["batch"]
        loss_fn, make_train = recsys_train_fns(arch, cfg)
        a_opt = optim.init_opt_state(a_params)
        o_sh = _opt_shardings(a_opt, p_sh, mesh, "recsys")
        loss = _rows_loss(loss_fn, row_tables=two_tower, own_mean=two_tower)
        step = _train_step(loss, cfg, optim.apply_updates, optim.AdamWConfig())
        batch = _meta_batch(make_train, b)
        return StepBundle(f"{arch.name}:{shape.name}:train", step, (a_params, a_opt, batch),
                          (p_sh, o_sh, b_shardings(batch, b)),
                          (p_sh, o_sh, {"loss": _named(mesh, P())}),
                          6.0 * b * (2 * emb * 1024))
    if shape.kind == "serve":
        b = 64 if smoke else dims["batch"]
        batch = _meta_batch(make_serve, b)
        return StepBundle(f"{arch.name}:{shape.name}:serve",
                          _on_rows(serve_fn, row_tables=two_tower), (a_params, batch),
                          (p_sh, b_shardings(batch, b)),
                          _named(mesh, batch_spec(mesh, b, 1)) if mesh is not None else None,
                          2.0 * b * (2 * emb * 1024))
    c = 4096 if smoke else dims["n_candidates"]
    batch = _meta_batch(make_retr, c)

    def cand_spec(leaf):
        # candidate-major arrays shard over "data"; tiny query arrays replicate
        if leaf.dim() and leaf.shape[0] == c:
            return batch_spec(mesh, c, leaf.dim())
        if leaf.dim() == 2 and leaf.shape[1] == c:
            return P(None, batch_spec(mesh, c, 1)[0])
        return P()

    return StepBundle(f"{arch.name}:{shape.name}:retrieval",
                      _on_rows(retr_fn, row_tables=two_tower), (a_params, batch),
                      (p_sh, _shardings(batch, mesh, cand_spec)),
                      _named(mesh, batch_spec(mesh, c, 1)) if mesh is not None else None,
                      2.0 * c * emb)


def build_step(arch: Arch, shape: ShapeSpec, mesh, smoke: bool = False,
               opts: Optional[dict] = None) -> StepBundle:
    """The reference's ``build_step``: ``(arch, shape, mesh)`` -> a
    :class:`StepBundle`.  ``mesh`` is a ``DeviceMesh`` (``make_smoke_mesh``,
    ``make_production_mesh``) or None (one device, nothing placed)."""
    if arch.family == "lm":
        return _build_lm(arch, shape, mesh, smoke, opts)
    if arch.family == "gnn":
        return _build_gnn(arch, shape, mesh, smoke, opts)
    if arch.family == "recsys":
        return _build_recsys(arch, shape, mesh, smoke)
    raise ValueError(arch.family)


def input_specs(arch: Arch, shape: ShapeSpec, mesh, smoke: bool = False):
    """Meta stand-ins for every model input (the dry-run's contract)."""
    return build_step(arch, shape, mesh, smoke=smoke).inputs


__all__ = [
    "BoundStep",
    "LMStep",
    "RECSYS_INIT",
    "StepBundle",
    "build_gnn_step",
    "build_lm_step",
    "build_recsys_step",
    "build_step",
    "gnn_batch",
    "gnn_model_flops",
    "input_specs",
    "lm_config",
    "mesh_update",
    "place",
    "place_tree",
    "recsys_fns",
    "recsys_train_fns",
    "value_and_grad",
]
