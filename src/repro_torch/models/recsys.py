"""RecSys architectures: the port of ``repro.models.recsys``.

Two-tower retrieval, SASRec, DIN and MIND with the reference's numerics.
The shared hot path is the sparse EmbeddingBag: :func:`embedding_bag`
sends ``sum`` and ``mean`` bags through
:func:`repro_torch.kernels.embedding_bag.embedding_bag_op`, the CUDA kernel
on the card (the TPU package keeps its Pallas kernel off the model's path;
the port routes the model's bags through its kernel, with the same
results).  ``max`` stays plain PyTorch: no kernel computes it in either
package, and no served model uses it.  The op is differentiable with
respect to the table (the kernel forward, PyTorch's ``index_add_``
backward), so two-tower trains through the kernel.

Parameters are trees of dicts and lists of tensors, named as the
reference's.  Initialisation draws from an explicit ``torch.Generator`` on
its device; the tests carry the JAX weights across instead
(:func:`params_from_numpy`).  Each architecture has the reference's
training loss: :func:`two_tower_loss` (in-batch softmax), :func:`sasrec_loss`,
:func:`din_loss` and :func:`mind_loss`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.embedding_bag import embedding_bag_op
from . import spmd
from .common import tensor_from_numpy, truncated_normal

Params = Any


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------


class RowShard(NamedTuple):
    """A table whose rows rest sharded over mesh dims (``RECSYS_RULES``'
    ``Shard(0)`` over "model"): the rank's block of rows, the first row it
    holds, the mesh and those dims."""

    local: torch.Tensor
    offset: int
    mesh: Any
    dims: Tuple[int, ...]


def row_shard(table, partial_dims=()) -> Any:
    """A DTensor table as :func:`embedding_bag` takes it on a mesh: a
    :class:`RowShard` of the rank's rows where they are sharded, else the
    whole table (:func:`~.spmd.use`); gradients ``Partial`` over
    ``partial_dims``."""
    if not spmd.is_dtensor(table):
        return table
    mesh = table.device_mesh
    dims = tuple(d for d in spmd.sharded_dims(table, 0) if mesh.size(d) > 1)
    local = spmd.use(table, partial_dims, shard={d: 0 for d in dims})
    if not dims:
        return local
    return RowShard(local, spmd.rank_in(mesh, dims) * local.shape[0], mesh, dims)


def _sharded_bag(table: RowShard, indices: torch.Tensor, mode: str, use_kernel: bool):
    """Each rank sums the rows of its block that the bags name (ids outside
    it become pads), the sums are all-reduced over the table's dims, and
    ``mean`` divides by the bag's count after."""
    ids = indices.to(torch.int64) - table.offset
    ids = torch.where((indices >= 0) & (ids >= 0) & (ids < table.local.shape[0]), ids, -1)
    out = embedding_bag_op(table.local, ids.contiguous(), "sum", use_kernel=use_kernel)
    out = spmd.sum_over(out, table.mesh, table.dims)
    if mode == "mean":
        count = (indices >= 0).sum(dim=1, dtype=torch.int32).clamp(min=1).float()
        out = (out.float() / count[:, None]).to(out.dtype)
    return out


def embedding_bag(
    table: torch.Tensor,  # (V, D)
    indices: torch.Tensor,  # (B, L) int32, padded with -1
    mode: str = "sum",
    use_kernel: bool = True,
) -> torch.Tensor:
    """Multi-hot bag lookup: per bag, the sum, mean or max of the rows its
    non-negative ids name (zeros for a bag of pads).  ``table`` may be a
    :class:`RowShard` (sum and mean)."""
    if isinstance(table, RowShard):
        if mode not in ("sum", "mean"):
            raise ValueError(f"a row-sharded table takes sum or mean bags, not {mode!r}")
        return _sharded_bag(table, indices, mode, use_kernel)
    if mode in ("sum", "mean"):
        return embedding_bag_op(table, indices, mode, use_kernel=use_kernel)
    if mode == "max":
        mask = indices >= 0
        rows = table[indices.clamp(min=0)]
        rows = torch.where(mask[..., None], rows, -torch.inf)
        out = rows.amax(dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(mode)


def _tn(shape, std, dtype, generator):
    return truncated_normal(shape, std, dtype, generator, generator.device)


def init_mlp(generator: torch.Generator, dims, dtype=torch.float32) -> Params:
    return [
        {
            "w": _tn((dims[i], dims[i + 1]), dims[i] ** -0.5, dtype, generator),
            "b": torch.zeros((dims[i + 1],), dtype=dtype, device=generator.device),
        }
        for i in range(len(dims) - 1)
    ]


def mlp(params: Params, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def params_from_numpy(tree: Any, device="cuda") -> Params:
    """The port's parameters on ``device`` from a recsys param tree of
    arrays ``np.array`` takes (the reference's ``jax.tree.map(np.asarray,
    params)``, or the port's own tree on the CPU), bit for bit: dicts and
    lists keep their structure."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def param_count(params: Params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-6)


# ---------------------------------------------------------------------------
# Two-tower retrieval [Yi et al., RecSys'19]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    n_users: int = 2_000_000
    n_items: int = 1_000_000
    n_user_feats: int = 8  # multi-hot user feature bag length
    n_item_feats: int = 4
    embed_dim: int = 256
    tower_dims: Tuple[int, ...] = (1024, 512, 256)
    dtype: Any = torch.float32


def init_two_tower(generator: torch.Generator, cfg: TwoTowerConfig) -> Params:
    """Seeded weights on the generator's device, with the reference's
    shapes, names and scales."""
    d = cfg.embed_dim
    return {
        "user_table": _tn((cfg.n_users, d), 0.05, cfg.dtype, generator),
        "item_table": _tn((cfg.n_items, d), 0.05, cfg.dtype, generator),
        "user_tower": init_mlp(generator, (d,) + cfg.tower_dims, cfg.dtype),
        "item_tower": init_mlp(generator, (d,) + cfg.tower_dims, cfg.dtype),
    }


def two_tower_user(params: Params, user_feats: torch.Tensor, cfg: TwoTowerConfig,
                   use_kernel: bool = True) -> torch.Tensor:
    u = embedding_bag(params["user_table"], user_feats, "mean", use_kernel)
    return _normalise(mlp(params["user_tower"], u))


def two_tower_item(params: Params, item_feats: torch.Tensor, cfg: TwoTowerConfig,
                   use_kernel: bool = True) -> torch.Tensor:
    i = embedding_bag(params["item_table"], item_feats, "mean", use_kernel)
    return _normalise(mlp(params["item_tower"], i))


def two_tower_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: TwoTowerConfig,
                   use_kernel: bool = True, ctx: Optional[spmd.Spmd] = None) -> torch.Tensor:
    """Sampled softmax with in-batch negatives (the standard recipe).  On a
    mesh (``ctx``: the batch's rows are the rank's own) each rank scores its
    users against the whole batch's items, gathered, and the ranks' means
    are averaged."""
    u = two_tower_user(params, batch["user_feats"], cfg, use_kernel)  # (B, d)
    i = two_tower_item(params, batch["item_feats"], cfg, use_kernel)  # (B, d)
    first = 0
    if ctx is not None:
        i = spmd.gather_partial(i, ctx.mesh, ctx.batch_dims, 0)
        first = spmd.rank_in(ctx.mesh, ctx.batch_dims) * u.shape[0]
    logits = (u @ i.T).float() / 0.05  # (B, B), temperature
    labels = torch.arange(first, first + u.shape[0], device=u.device)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    return loss if ctx is None else spmd.mean_over(loss, ctx.mesh, ctx.batch_dims)


def two_tower_score_candidates(
    params: Params, user_feats: torch.Tensor, cand_feats: torch.Tensor, cfg: TwoTowerConfig,
    use_kernel: bool = True,
) -> torch.Tensor:
    """retrieval_cand shape: one query against n_candidates items."""
    u = two_tower_user(params, user_feats, cfg, use_kernel)  # (1, d)
    c = two_tower_item(params, cand_feats, cfg, use_kernel)  # (C, d)
    return (u @ c.T)[0]  # (C,)


# ---------------------------------------------------------------------------
# SASRec [arXiv:1808.09781]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    n_items: int = 2_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    d_ff: int = 200
    dtype: Any = torch.float32


def init_sasrec(generator: torch.Generator, cfg: SASRecConfig) -> Params:
    d = cfg.embed_dim
    item = _tn((cfg.n_items, d), 0.05, cfg.dtype, generator)
    pos = _tn((cfg.seq_len, d), 0.05, cfg.dtype, generator)
    blocks = [
        {
            "wq": _tn((d, d), d**-0.5, cfg.dtype, generator),
            "wk": _tn((d, d), d**-0.5, cfg.dtype, generator),
            "wv": _tn((d, d), d**-0.5, cfg.dtype, generator),
            "ffn": init_mlp(generator, (d, cfg.d_ff, d), cfg.dtype),
        }
        for _ in range(cfg.n_blocks)
    ]
    return {"item_table": item, "pos_table": pos, "blocks": blocks}


def sasrec_encode(params: Params, seq: torch.Tensor, cfg: SASRecConfig) -> torch.Tensor:
    """seq (B, L) item history -> (B, d) user state (last position)."""
    b, l = seq.shape
    mask = seq >= 0
    x = params["item_table"][seq.clamp(min=0)]
    x = x + params["pos_table"][None, :l]
    x = x * mask[..., None].to(x.dtype)
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=seq.device))
    for blk in params["blocks"]:
        q = x @ blk["wq"].to(x.dtype)
        k = x @ blk["wk"].to(x.dtype)
        v = x @ blk["wv"].to(x.dtype)
        logits = torch.einsum("bld,bmd->blm", q, k).float()
        logits = logits / math.sqrt(cfg.embed_dim)
        valid = causal[None] & mask[:, None, :]
        logits = torch.where(valid, logits, -1e30)
        att = torch.softmax(logits, dim=-1).to(x.dtype)
        x = x + torch.einsum("blm,bmd->bld", att, v)
        x = x + mlp(blk["ffn"], x)
        x = x * mask[..., None].to(x.dtype)
    return x[:, -1]


def sasrec_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: SASRecConfig) -> torch.Tensor:
    state = sasrec_encode(params, batch["seq"], cfg)  # (B, d)
    pos = params["item_table"][batch["pos_item"]]
    neg = params["item_table"][batch["neg_item"]]
    pos_s = (state * pos).sum(-1).float()
    neg_s = (state * neg).sum(-1).float()
    return -(F.logsigmoid(pos_s) + F.logsigmoid(-neg_s)).mean()


def sasrec_score(params: Params, batch: Dict[str, torch.Tensor], cfg: SASRecConfig) -> torch.Tensor:
    state = sasrec_encode(params, batch["seq"], cfg)
    items = params["item_table"][batch["candidates"]]  # (B, C, d)
    return torch.einsum("bd,bcd->bc", state, items)


# ---------------------------------------------------------------------------
# DIN [arXiv:1706.06978]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINConfig:
    n_items: int = 5_000_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_dims: Tuple[int, ...] = (80, 40)
    mlp_dims: Tuple[int, ...] = (200, 80)
    dtype: Any = torch.float32


def init_din(generator: torch.Generator, cfg: DINConfig) -> Params:
    d = cfg.embed_dim
    return {
        "item_table": _tn((cfg.n_items, d), 0.05, cfg.dtype, generator),
        # attention MLP input: [hist, target, hist-target, hist*target]
        "attn": init_mlp(generator, (4 * d,) + cfg.attn_dims + (1,), cfg.dtype),
        "mlp": init_mlp(generator, (2 * d,) + cfg.mlp_dims + (1,), cfg.dtype),
    }


def din_forward(params: Params, batch: Dict[str, torch.Tensor], cfg: DINConfig) -> torch.Tensor:
    """CTR logit per (user history, target item) pair."""
    table = params["item_table"]
    hist = table[batch["hist"].clamp(min=0)]  # (B, L, d)
    mask = (batch["hist"] >= 0).to(hist.dtype)
    target = table[batch["target"]]  # (B, d)
    t = target[:, None].expand_as(hist)
    feat = torch.cat([hist, t, hist - t, hist * t], dim=-1)  # (B, L, 4d)
    scores = mlp(params["attn"], feat)[..., 0].float()  # (B, L)
    scores = torch.where(mask > 0, scores, -1e30)
    # softmax + mask, as the reference keeps it (DIN's paper uses sigmoid)
    w = torch.softmax(scores, dim=-1).to(hist.dtype)
    interest = torch.einsum("bl,bld->bd", w, hist)
    x = torch.cat([interest, target], dim=-1)
    return mlp(params["mlp"], x)[..., 0]


def din_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: DINConfig) -> torch.Tensor:
    logit = din_forward(params, batch, cfg).float()
    y = batch["label"].float()
    return torch.mean(logit.clamp(min=0) - logit * y + torch.log1p(torch.exp(-logit.abs())))


# ---------------------------------------------------------------------------
# MIND [arXiv:1904.08030] -- multi-interest capsule routing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    n_items: int = 2_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    dtype: Any = torch.float32


def init_mind(generator: torch.Generator, cfg: MINDConfig) -> Params:
    d = cfg.embed_dim
    return {
        "item_table": _tn((cfg.n_items, d), 0.05, cfg.dtype, generator),
        "bilinear": _tn((d, d), d**-0.5, cfg.dtype, generator),
        "label_attn_pow": torch.tensor(2.0, dtype=torch.float32, device=generator.device),
    }


def _squash(v: torch.Tensor) -> torch.Tensor:
    n2 = v.square().sum(dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


def mind_interests(params: Params, seq: torch.Tensor, cfg: MINDConfig) -> torch.Tensor:
    """Dynamic-routing capsules: history (B, L) -> interests (B, K, d)."""
    mask = seq >= 0
    e = params["item_table"][seq.clamp(min=0)]
    e = e * mask[..., None].to(e.dtype)
    u = e @ params["bilinear"].to(e.dtype)  # (B, L, d) behaviour capsules
    b, l = seq.shape
    k = cfg.n_interests
    logits = torch.zeros((b, k, l), dtype=torch.float32, device=seq.device)
    interests = torch.zeros((b, k, cfg.embed_dim), dtype=u.dtype, device=seq.device)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1)  # over interests
        w = w * mask[:, None, :].to(w.dtype)
        s = torch.einsum("bkl,bld->bkd", w.to(u.dtype), u)
        interests = _squash(s.float()).to(u.dtype)
        logits = logits + torch.einsum("bkd,bld->bkl", interests, u).float()
    return interests


def mind_score(params: Params, batch: Dict[str, torch.Tensor], cfg: MINDConfig) -> torch.Tensor:
    """Label-aware attention scoring of candidates against interests."""
    interests = mind_interests(params, batch["seq"], cfg)  # (B, K, d)
    items = params["item_table"][batch["candidates"]]  # (B, C, d)
    sim = torch.einsum("bkd,bcd->bkc", interests, items).float()
    p = torch.softmax(params["label_attn_pow"] * sim, dim=1)
    return (p * sim).sum(dim=1)  # (B, C)


def mind_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: MINDConfig) -> torch.Tensor:
    scores = mind_score(params, batch, cfg)  # (B, C) candidate 0 is positive
    logp = torch.log_softmax(scores, dim=-1)
    return -logp[:, 0].mean()
