"""Decoder-only transformer for LM serving and training: the port of
``repro.models.transformer`` (dense layers).

One implementation, config-switched as in the reference: GQA / MQA
attention (query head ``kv * G + g``), RoPE, gated activations (GeGLU,
SwiGLU), local/global alternating attention with a sliding window, the
attention and final logit softcaps, post norms, query scale, qkv bias, and
tied or untied embeddings.

Parameters are a :class:`ParamTree`: an ``nn.Module`` holding the
reference's layer-stacked tensors under its tree's names
(``params["layers"]["attn"]["q"]`` is ``(L, d, H * hd)``), so
:func:`params_from_numpy` carries the JAX weights across unchanged.  A
Python loop over the layers takes the place of ``lax.scan``.

Serving: :func:`forward`, :func:`prefill`, :func:`init_cache` and
:func:`decode_step`.  Decode attention runs through
:func:`repro_torch.kernels.decode_attention.decode_attention_op` (the CUDA
kernel on the card) on layer i's ``(B, S, Hkv, d)`` cache slice; the cache
is updated in place, and its fill level ``len`` is a 0-d int32 tensor on
the device, so a decode step makes no host sync.  With the
``decode_window_slice`` lever a local layer attends only over its window
slice, as the reference's: the kernel's window-slice mode plans its split
over the window's keys and finds the slice's start from ``len`` on the
device.

Training: :func:`loss_fn` is ``forward`` then the shifted token
cross-entropy, differentiable with respect to every parameter.  Each
stacked ``(L, ...)`` parameter is unbound into its L layers once per
forward, so the layers' gradients are stacked back in one copy.  With
``cfg.remat`` and gradients enabled each layer runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward pass, as the reference's ``jax.checkpoint(body,
policy=nothing_saveable)``.  Attention in training is the plain chunked
:func:`_attend` (f32 scores and weights), as in the reference, where it is
plain XLA: no Pallas kernel computes it.

MoE layers (llama4-scout top-1 with a shared expert, arctic top-2 with a
dense residual FFN) run the reference's single-shard body ``_moe_local``:
f32 routing, top-k with the lower expert first among ties, a stable sort
of the slots by expert, and the expert FFNs by ``impl``: ``"capacity"``
(the default: a window of ``cap`` slots per expert, GShard drops, shapes
fixed by the token count, so no host sync and a decode step stays
graph-shaped) or ``"ragged"`` (dropless, one product per non-empty group;
it reads the group sizes on the host).  ``forward`` returns the layers'
mean Switch aux and ``loss_fn`` adds ``router_aux_weight`` times it.

On a mesh (DTensor tokens and parameters, placed by
``repro_torch.launch.steps.build_step``) each rank computes on its batch
rows with every parameter gathered whole (:mod:`.spmd`), except the
reference's two mesh paths.  The shard-local MoE (``moe_batch_axes``):
routing, top-k and the slot sort local to each batch shard, the experts'
``wi``/``wo`` gathered over ``moe_fsdp_axes`` for each layer, the FFN
tensor-parallel over ``moe_tp_axis`` (F sliced, the output summed), the
aux the mean of the shards' auxes; tokens not sharded over the batch axes
are padded to the shard count, as the reference pads them.  The
sequence-parallel residual (``act_seq_axis``): between layers each rank
keeps its chunk of S (a checkpointed layer saves it), with the values of
the step without it.  A KV cache resting sharded on S or Hkv (the
reference's split-KV decode) is gathered a layer at a time for the
kernel's full read, and each rank writes back its part.
``set_moe_mesh`` sets the mesh those paths read, as the reference's
trace-time handle.  ``kv_quant`` is a field the reference declares and
never reads; the port does the same.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention import decode_attention_op
from . import spmd
from .common import (ACTIVATIONS, apply_rope, cross_entropy, dense, rmsnorm, softcap,
                     tensor_from_numpy, top_k_ids, tree_leaves, truncated_normal)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    dense_residual_ff: int = 0
    router_aux_weight: float = 0.01
    impl: str = "capacity"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field (``dtype`` a torch dtype)."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "silu"  # gate activation: "silu" (SwiGLU) | "gelu" (GeGLU)
    rope_theta: float = 10_000.0
    #: "global" or "local_global" (even layers local / odd global, gemma2)
    attn_pattern: str = "global"
    window: int = 4096
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    #: overrides the default head_dim**-0.5 attention scale
    query_scale: Optional[float] = None
    qkv_bias: bool = False
    post_norms: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    moe_batch_axes: Optional[Tuple[str, ...]] = None
    moe_tp_axis: Optional[str] = None
    moe_fsdp_axes: Tuple[str, ...] = ()
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    #: query chunk for memory-bounded attention (None = unchunked)
    q_chunk: Optional[int] = 1024
    remat: bool = True
    scan_layers: bool = True
    act_seq_axis: Optional[str] = None
    decode_window_slice: bool = False
    kv_quant: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_is_local(self) -> np.ndarray:
        if self.attn_pattern == "local_global":
            return (np.arange(self.n_layers) % 2) == 0
        return np.zeros(self.n_layers, dtype=bool)

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe is not None:
            ff = self.moe.n_experts * (3 * d * self.moe.d_ff) + d * self.moe.n_experts
            if self.moe.dense_residual_ff:
                ff += 3 * d * self.moe.dense_residual_ff
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim * d
        ff = self.moe.top_k * (3 * d * self.moe.d_ff) + d * self.moe.n_experts
        if self.moe.dense_residual_ff:
            ff += 3 * d * self.moe.dense_residual_ff
        per_layer = attn + ff + 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors as a module, indexed like the reference's
    pytree: ``params["layers"]["mlp"]["wi"]``.  The parameters are built
    without gradients (serving); training turns them on
    (``params.requires_grad_()``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self) -> Dict[str, Any]:
        """The parameters themselves as a nested dict (gradients reach
        them through what is computed from them)."""
        out: Dict[str, Any] = dict(self._parameters)
        out.update({n: m.tree() for n, m in self._modules.items()})
        return out


def _layout(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree as ``(how, shape, std, dtype)`` leaves, the
    reference's shapes, names and scales (``init_params``, ``init_layer``):
    ``how`` is ``"tn"`` (one truncated normal), ``"stacked"`` (one per
    layer), ``"experts"`` (one per layer and expert) or ``"zeros"``; shapes
    are the whole leaf's."""
    d, hd, n_l, dt = cfg.d_model, cfg.head_dim, cfg.n_layers, cfg.dtype

    def stacked(shape, std, dtype=dt):
        return ("stacked", (n_l, *shape), std, dtype)

    def zeros(*shape):
        return ("zeros", shape, 0.0, dt)

    attn = {
        "q": stacked((d, cfg.n_heads * hd), d**-0.5),
        "k": stacked((d, cfg.n_kv_heads * hd), d**-0.5),
        "v": stacked((d, cfg.n_kv_heads * hd), d**-0.5),
        "o": stacked((cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        attn["q_bias"] = zeros(n_l, cfg.n_heads * hd)
        attn["k_bias"] = zeros(n_l, cfg.n_kv_heads * hd)
        attn["v_bias"] = zeros(n_l, cfg.n_kv_heads * hd)
    layers: Dict[str, Any] = {
        "attn": attn,
        "pre_attn_norm": {"scale": zeros(n_l, d)},
        "pre_mlp_norm": {"scale": zeros(n_l, d)},
    }
    m = cfg.moe
    if m is not None:
        # wi (E, D, 2, F): gate and up on an axis of their own, as the reference's
        layers["moe"] = {
            "router": stacked((d, m.n_experts), d**-0.5, torch.float32),
            "wi": ("experts", (n_l, m.n_experts, d, 2, m.d_ff), d**-0.5, dt),
            "wo": ("experts", (n_l, m.n_experts, m.d_ff, d), m.d_ff**-0.5, dt),
        }
    ff = cfg.d_ff if m is None else m.dense_residual_ff
    if ff:
        layers["mlp"] = {
            "wi": stacked((d, 2 * ff), d**-0.5),
            "wo": stacked((ff, d), ff**-0.5),
        }
    if cfg.post_norms:
        layers["post_attn_norm"] = {"scale": zeros(n_l, d)}
        layers["post_mlp_norm"] = {"scale": zeros(n_l, d)}
    tree: Dict[str, Any] = {
        "embed": ("tn", (cfg.vocab_size, d), 1.0, dt),
        "layers": layers,
        "final_norm": {"scale": zeros(d)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("tn", (d, cfg.vocab_size), d**-0.5, dt)
    return tree


def _build(layout, leaf) -> Dict[str, Any]:
    return {k: _build(v, leaf) if isinstance(v, dict) else leaf(*v) for k, v in layout.items()}


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> ParamTree:
    """Seeded random weights on the generator's device, with the
    reference's shapes, names and scales (``init_params``, ``init_layer``).
    Stacked tensors are drawn a layer at a time, and the experts' an expert
    at a time, so the f32 draw never holds more than one layer's tensor or
    one expert's (a layer of arctic's ``wi`` is 35.7 GB in f32)."""
    dev = generator.device

    def leaf(how, shape, std, dtype):
        if how == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if how == "tn":
            return truncated_normal(shape, std, dtype, generator, dev)
        out = torch.empty(shape, dtype=dtype, device=dev)
        lead = shape[:1] if how == "stacked" else shape[:2]
        for i in np.ndindex(*lead):
            out[i] = truncated_normal(shape[len(lead):], std, dtype, generator, dev)
        return out

    layout = _layout(cfg)
    layers = _build(layout["layers"], leaf)  # drawn before the embeddings, as ever
    return ParamTree({k: layers if k == "layers" else (_build(v, leaf) if isinstance(v, dict)
                                                        else leaf(*v))
                      for k, v in layout.items()})


def abstract_params(cfg: TransformerConfig) -> ParamTree:
    """:func:`init_params`' tree on ``meta``: shapes and dtypes without
    bytes or draws (the reference's ``jax.eval_shape`` of its init)."""
    return ParamTree(_build(_layout(cfg), lambda how, shape, std, dtype: torch.empty(
        shape, dtype=dtype, device="meta")))


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> ParamTree:
    """The port's parameters from the reference's ``init_params`` pytree as
    numpy arrays (``jax.tree.map(np.asarray, params)``), bit for bit."""
    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else tensor_from_numpy(v, device)
                for k, v in t.items()}

    return ParamTree(conv(tree))


def _layers(params: ParamTree, n_layers: int):
    """Each layer's slice of the stacked layer tree, as nested dicts: every
    stacked parameter unbound once, so a backward pass stacks its layers'
    gradients in one copy (indexing it per layer would add a zero-padded
    full-size gradient per layer)."""
    def unbound(t):
        if isinstance(t, dict):
            return {k: unbound(v) for k, v in t.items()}
        return t.unbind(0)

    def layer(t, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in t.items()}

    layers = params["layers"]
    stacked = unbound(layers.tree() if isinstance(layers, nn.Module) else layers)
    return [layer(stacked, i) for i in range(n_layers)]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _scale(cfg: TransformerConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None else cfg.head_dim**-0.5


def _f32_scores(q, k) -> torch.Tensor:
    """``einsum("bqngh,bknh->bqngk")`` of the upcast operands, in f32.  On
    the card the product follows the caller's
    ``torch.backends.cuda.matmul.allow_tf32``: off (PyTorch's default), IEEE
    f32; on, the TF32 tensor cores, several times faster.  Products of bf16
    operands are exact there (their 8 significant bits fit TF32's 11), but
    the cores' sums are not IEEE f32, as an XLA bf16 dot with f32
    accumulation on a GPU is not either.  The model sets no precision: its
    entry point does."""
    return torch.einsum("bqngh,bknh->bqngk", q.float(), k.float())


def _attention_scores(q, k, cfg: TransformerConfig, q_pos, k_pos, is_local: bool):
    """q: (B, Sq, Nkv, G, hd); k: (B, Sk, Nkv, hd) -> f32 weights
    (B, Sq, Nkv, G, Sk): f32 scores of the operands, softcap, mask, f32
    softmax."""
    logits = _f32_scores(q, k).mul_(_scale(cfg))
    logits = softcap(logits, cfg.attn_logit_softcap)
    mask = k_pos[None, :] <= q_pos[:, None]  # (Sq, Sk)
    if is_local:
        mask = mask & (k_pos[None, :] > (q_pos[:, None] - cfg.window))
    logits.masked_fill_(~mask[None, :, None, None, :], NEG_INF)
    return torch.softmax(logits, dim=-1)


def _attend(q, k, v, cfg: TransformerConfig, positions, is_local: bool):
    """Causal self-attention over ``positions = arange(S)`` (queries and
    keys alike), in query chunks of ``cfg.q_chunk``.  The f32 weights
    multiply the upcast V; the result is cast to q's dtype.

    A chunk reads only the keys its mask can keep (up to its last query,
    and from its first query's window on a local layer): the keys it skips
    weigh exp(-1e30 - m) = 0 in the reference, so this is the same
    function.  Unlike the reference, which falls back to the unchunked
    (S, S) scores when S is not a multiple of ``q_chunk``, a ragged last
    chunk is chunked too."""
    sq = q.shape[1]
    chunk = cfg.q_chunk
    vf = v.float()
    if chunk is None or sq <= chunk:
        w = _attention_scores(q, k, cfg, positions, positions, is_local)
        return torch.einsum("bqngk,bknh->bqngh", w, vf).to(q.dtype)
    outs = []
    for c0 in range(0, sq, chunk):
        c1 = min(c0 + chunk, sq)
        lo = max(0, c0 - cfg.window + 1) if is_local else 0
        w = _attention_scores(q[:, c0:c1], k[:, lo:c1], cfg, positions[c0:c1],
                              positions[lo:c1], is_local)
        outs.append(torch.einsum("bqngk,bknh->bqngh", w, vf[:, lo:c1]).to(q.dtype))
    return torch.cat(outs, dim=1)


def _qkv(layer, x: torch.Tensor, cfg: TransformerConfig, positions):
    b, s, _ = x.shape
    a = layer["attn"]
    q = dense(a["q"], x)
    k = dense(a["k"], x)
    v = dense(a["v"], x)
    if cfg.qkv_bias:
        q = q + a["q_bias"].to(q.dtype)
        k = k + a["k_bias"].to(k.dtype)
        v = v + a["v_bias"].to(v.dtype)
    q = q.reshape(b, s, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q.reshape(b, s, -1, cfg.head_dim), positions, cfg.rope_theta).reshape(q.shape)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# FFN, layer, model
# ---------------------------------------------------------------------------


def _act(cfg: TransformerConfig, gate: torch.Tensor) -> torch.Tensor:
    return ACTIVATIONS["gelu" if cfg.activation == "gelu" else "silu"](gate)


def _dense_ffn(mlp, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    gate, up = dense(mlp["wi"], x).chunk(2, dim=-1)
    return dense(mlp["wo"], _act(cfg, gate) * up)


def _route(x: torch.Tensor, router: torch.Tensor, cfg: TransformerConfig):
    """``(probs (T, E), weights (T, k), experts (T, k))``: the f32 router's
    softmax, its top k (the lower expert first among equal probabilities,
    as ``jax.lax.top_k``) and their probabilities renormalised to sum 1."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    experts = top_k_ids(probs, m.top_k)
    weights = probs.gather(-1, experts)
    return probs, weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9), experts


def _group_sizes(flat_expert: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) int64 slots per expert, by a one-hot sum (``torch.bincount``
    reads its length on the host)."""
    ids = torch.arange(n_experts, device=flat_expert.device)
    return (flat_expert[:, None] == ids).sum(dim=0)


def _capacity(m: MoEConfig, tk: int, n_experts: int) -> int:
    """The slots an expert's window holds: ``cf * T * k / E`` rounded up to
    a multiple of 8, at least 8 and at most ``T * k``."""
    cap = math.ceil(m.capacity_factor * tk / n_experts / 8) * 8
    return min(max(cap, 8), tk)


def _expert_ffn(cfg: TransformerConfig, x: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """The gated FFN of experts at once: x (..., C, D), wi (..., D, 2, F),
    wo (..., F, D), in x's dtype."""
    f = wi.shape[-1]
    h = x @ wi.reshape(*wi.shape[:-2], 2 * f).to(x.dtype)
    return (_act(cfg, h[..., :f]) * h[..., f:]) @ wo.to(x.dtype)


def _capacity_grouped_ffn(xs: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                          group_sizes: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The expert FFNs with a fixed capacity per expert, GShard drops.

    xs (T*k, D) are the slots sorted by expert.  Each expert computes on
    the window of ``cap`` slots at its group's start, the start clamped to
    ``T*k - cap``; a slot counts only in its own expert's window, so a
    group longer than ``cap`` drops its tail and the windows' overlaps add
    zeros.  All experts' windows go in one batched product, and the
    windows are added back out of place, every shape fixed by T*k: no host
    sync, so a decode step stays graph-shaped."""
    tk, d = xs.shape
    e = wi.shape[0]
    cap = _capacity(cfg.moe, tk, e)
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    pos = starts.clamp(max=tk - cap)[:, None] + torch.arange(cap, device=xs.device)  # (E, cap)
    y = _expert_ffn(cfg, xs.index_select(0, pos.reshape(-1)).reshape(e, cap, d), wi, wo)
    valid = (pos >= starts[:, None]) & (pos < (starts + group_sizes)[:, None])
    y = y.masked_fill(~valid[..., None], 0.0)
    return torch.zeros_like(xs).index_add(0, pos.reshape(-1), y.reshape(e * cap, d))


def _ragged_ffn(xs: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                group_sizes: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The expert FFNs without drops (the reference's ``ragged_dot``): one
    product per non-empty group of the sorted slots xs (T*k, D).  The group
    sizes are read on the host, a sync."""
    outs, start = [], 0
    for i, n in enumerate(group_sizes.tolist()):
        if n:
            outs.append(_expert_ffn(cfg, xs[start : start + n], wi[i], wo[i]))
            start += n
    return torch.cat(outs)


def _moe_local(x: torch.Tensor, router, wi, wo, cfg: TransformerConfig, tp=None):
    """The reference's shard-local MoE body: x (T, D), router (D, E), wi
    (E, D, 2, F), wo (E, F, D) -> ``(out (T, D) in x's dtype, the Switch
    aux: E * sum(fraction routed first * mean prob))``.

    The slots (token, choice) are sorted by expert with a stable sort, so
    an expert's slots keep token order; the FFN output is scattered back to
    slot order and summed over the k choices with the routing weights.
    With ``tp = (mesh, dims)`` the experts' F is the rank's slice, and the
    FFN's output is summed over those mesh dims (the reference's ``psum``
    over ``tp_axis``)."""
    m = cfg.moe
    probs, weights, experts = _route(x, router, cfg)
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    xs = x.index_select(0, order // m.top_k)
    if tp is not None:
        xs = spmd.tp_enter(xs, *tp)
    sizes = _group_sizes(flat, m.n_experts)
    ffn = _ragged_ffn if m.impl == "ragged" else _capacity_grouped_ffn
    y = ffn(xs, wi, wo, sizes, cfg)
    if tp is not None:
        y = spmd.sum_over(y, *tp)
    unsorted = torch.zeros_like(y).index_copy(0, order, y)
    out = (unsorted.reshape(x.shape[0], m.top_k, -1) * weights[..., None].to(y.dtype)).sum(dim=1)
    frac = _group_sizes(experts[:, 0], m.n_experts).float() / x.shape[0]
    aux = m.n_experts * torch.sum(frac * probs.mean(dim=0))
    return out.to(x.dtype), aux


def _moe_ffn(moe_p, x: torch.Tensor, cfg: TransformerConfig, batch_dims=()):
    """The MoE over x's (T, D) tokens: ``_moe_local`` over all of them
    without ``cfg.moe_batch_axes``, else the shard-local MoE on the mesh of
    :func:`set_moe_mesh`.  ``batch_dims`` are the mesh dims over which x's
    rows are already the rank's own (the step's batch sharding)."""
    if cfg.moe_batch_axes is None:
        return _moe_local(x, spmd.use(moe_p["router"], batch_dims),
                          spmd.use(moe_p["wi"], batch_dims), spmd.use(moe_p["wo"], batch_dims),
                          cfg)
    return _moe_sharded(moe_p, x, cfg, tuple(batch_dims))


def _experts(w, mesh, bdims, tdims, f_dim: int):
    """An expert weight as the MoE body takes it: whole over the expert
    axis (gathered over the FSDP axes it rests on, its gradient
    reduce-scattered back) and the rank's slice of F over the tensor-
    parallel dims.  A plain tensor is sliced."""
    if spmd.is_dtensor(w):
        return spmd.use(w, bdims, shard={d: f_dim for d in tdims})
    return spmd._chunk(w, mesh, tdims, f_dim)


def _moe_sharded(moe_p, x: torch.Tensor, cfg: TransformerConfig, batch_dims):
    """The reference's shard_map'd MoE: routing, top-k and the slot sort
    local to each shard of ``cfg.moe_batch_axes``; the experts' ``wi``/``wo``
    gathered over ``cfg.moe_fsdp_axes`` for this layer; the expert FFN
    tensor-parallel over ``cfg.moe_tp_axis`` (F sliced, the output summed);
    the aux the mean of the shards' auxes (the reference's ``pmean`` over
    the batch axes; its ``pmean`` over tp averages equal values).

    Tokens not already sharded over the batch axes (a decode batch that
    does not divide) are padded with zero rows to the shard count and each
    shard takes its block: the pads route like any token, count in the
    aux, and are cut after the output is gathered back."""
    mesh = get_moe_mesh()
    bdims = spmd.mesh_dims(mesh, cfg.moe_batch_axes)
    tdims = spmd.mesh_dims(mesh, (cfg.moe_tp_axis,)) if cfg.moe_tp_axis else ()
    t = x.shape[0]
    split = set(batch_dims) != set(bdims)
    if split:
        if batch_dims:
            raise ValueError(f"tokens sharded over mesh dims {batch_dims}, the MoE's batch "
                             f"axes are {cfg.moe_batch_axes}")
        pad = (-t) % spmd.group_size(mesh, bdims)
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        x = spmd.chunk_over(x, mesh, bdims, 0)
    router = spmd.use(moe_p["router"], bdims)
    wi = _experts(moe_p["wi"], mesh, bdims, tdims, 3)
    wo = _experts(moe_p["wo"], mesh, bdims, tdims, 1)
    out, aux = _moe_local(x, router, wi, wo, cfg, (mesh, tdims) if tdims else None)
    aux = spmd.mean_over(aux, mesh, bdims)
    if split:
        out = spmd.gather_over(out, mesh, bdims, 0)[:t]
    return out, aux


# Mesh handle for the shard-local MoE and the sequence-parallel residual
# (set by the step builders, as the reference's trace-time handle).
_MOE_MESH = None


def set_moe_mesh(mesh) -> None:
    global _MOE_MESH
    _MOE_MESH = mesh


# alias: the mesh context is used by more than the MoE
set_mesh = set_moe_mesh


def get_moe_mesh():
    if _MOE_MESH is None:
        raise RuntimeError("set_moe_mesh(mesh) must be called before tracing a "
                           "distributed MoE step")
    return _MOE_MESH


def _finish(layer, x, attn, cfg: TransformerConfig, batch_dims=()):
    """The rest of a layer after attention: output projection, post norm,
    residual, then the FFN block (the MoE, plus the dense residual FFN when
    the config has one): ``(x, aux)``."""
    b, s = x.shape[:2]
    attn = dense(layer["attn"]["o"], attn.reshape(b, s, cfg.n_heads * cfg.head_dim))
    if cfg.post_norms:
        attn = rmsnorm(layer["post_attn_norm"]["scale"], attn, cfg.norm_eps)
    x = x + attn
    h = rmsnorm(layer["pre_mlp_norm"]["scale"], x, cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = _moe_ffn(layer["moe"], h.reshape(b * s, -1), cfg, batch_dims=batch_dims)
        y = y.reshape(b, s, -1)
        if cfg.moe.dense_residual_ff:
            y = y + _dense_ffn(layer["mlp"], h, cfg)
    else:
        y, aux = _dense_ffn(layer["mlp"], h, cfg), torch.zeros((), device=x.device)
    if cfg.post_norms:
        y = rmsnorm(layer["post_mlp_norm"]["scale"], y, cfg.norm_eps)
    return x + y, aux


def layer_forward(
    layer,
    x: torch.Tensor,
    cfg: TransformerConfig,
    positions: torch.Tensor,
    is_local: bool,
    k_cache: Optional[torch.Tensor] = None,
    v_cache: Optional[torch.Tensor] = None,
    cache_len: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
    batch_dims: Tuple[int, ...] = (),
):
    """One decoder layer; returns ``(x, aux, new_cache)``.  In decode mode
    (caches given) x is (B, 1, D); the new K/V are written into the caches
    in place at ``cache_len``, clamped to the last slot as the reference's
    ``dynamic_update_slice`` clamps, and the attention is
    ``decode_attention_op`` over the whole (B, S, Hkv, d) buffer, or with
    ``cfg.decode_window_slice`` on a local layer over the slice of
    ``min(window, S)`` keys that ends at ``cache_len`` (the window mask
    then holds by construction, as in the reference).  ``batch_dims``: the
    mesh dims x's rows are sharded over (the shard-local MoE reads them)."""
    h = rmsnorm(layer["pre_attn_norm"]["scale"], x, cfg.norm_eps)
    q, k, v = _qkv(layer, h, cfg, positions)
    if k_cache is None:
        attn = _attend(q, k, v, cfg, positions, is_local)
        return (*_finish(layer, x, attn, cfg, batch_dims), None)
    slot = cache_len.clamp(0, k_cache.shape[1] - 1).long().reshape(1)
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    sliced = cfg.decode_window_slice and is_local
    attn = decode_attention_op(
        q[:, 0], k_cache, v_cache, cache_len, _scale(cfg), cfg.attn_logit_softcap,
        cfg.window if is_local and not sliced else None, use_kernel=use_kernel,
        window_slice=cfg.window if sliced else None,
    )
    return (*_finish(layer, x, attn, cfg, batch_dims), (k_cache, v_cache))


def _embed(params: ParamTree, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        # the scale is rounded to the model's dtype first: 45.25 in bf16 at d = 2048
        # (a CPU scalar tensor: passed to the kernel as a value, not copied)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def _unembed(params: ParamTree, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    # the product is rounded to the model's dtype before the f32 softcap
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).t()
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return softcap(logits.float(), cfg.final_logit_softcap)


_EXPERTS = re.compile(r"moe/w[io]$")


def _enter(params, tokens):
    """``(ctx, params, tokens)`` for a rank's local compute: with DTensor
    tokens (or parameters) ``ctx`` is the step's :class:`~.spmd.Spmd`, the
    tokens the rank's rows, and every parameter gathered whole but the
    experts (the shard-local MoE takes those).  Plain inputs pass through
    with ``ctx`` None."""
    ctx, tokens = spmd.enter(tokens)
    if ctx is None:
        mesh = spmd.mesh_of(params)
        if mesh is None:
            return None, params, tokens
        ctx = spmd.Spmd(mesh, ())
    return ctx, spmd.use_tree(params, ctx.batch_dims, skip=_EXPERTS.search), tokens


def _seq_axis(cfg: TransformerConfig):
    """``(mesh, dims)`` of the sequence-parallel residual, or None."""
    if cfg.act_seq_axis is None:
        return None
    mesh = get_moe_mesh()
    return mesh, spmd.mesh_dims(mesh, (cfg.act_seq_axis,))


def _seq_parallel_layer(seq, layer, x, cfg, positions, is_local, batch_dims):
    """A layer between two residuals sharded on S over ``seq``'s dims: the
    rank's chunk is gathered, the layer runs, and the rank keeps its chunk
    of the output."""
    x = spmd.gather_over(x, *seq, 1)
    x, aux, _ = layer_forward(layer, x, cfg, positions, is_local, batch_dims=batch_dims)
    return spmd.chunk_over(x, *seq, 1), aux, None


def _hidden_aux(params, tokens: torch.Tensor, cfg: TransformerConfig, batch_dims=()):
    """``(hidden(...), the layers' mean MoE aux)`` of local tokens.

    With ``cfg.act_seq_axis`` the residual stream between layers is
    sharded on S over that mesh axis (the reference's
    ``_constrain_residual``): each rank keeps S / n positions of it, so a
    checkpointed layer saves a chunk; the values are those without it."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    loc = cfg.layer_is_local()
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in tree_leaves(params))
    seq = _seq_axis(cfg)
    layer_fn = layer_forward
    if seq is not None:
        x = spmd.chunk_over(x, *seq, 1)
        layer_fn = functools.partial(_seq_parallel_layer, seq)
    auxes = []
    for i, layer in enumerate(_layers(params, cfg.n_layers)):
        if remat:
            x, aux, _ = checkpoint(layer_fn, layer, x, cfg, positions, bool(loc[i]),
                                   batch_dims=batch_dims, use_reentrant=False)
        else:
            x, aux, _ = layer_fn(layer, x, cfg, positions, bool(loc[i]), batch_dims=batch_dims)
        auxes.append(aux)
    if seq is not None:
        x = spmd.gather_over(x, *seq, 1)
    return rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps), torch.stack(auxes).mean()


def hidden(params: ParamTree, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The final-normed residual stream (B, S, D) of ``tokens`` (B, S).
    With ``cfg.remat``, when a gradient is being taken (gradients enabled,
    parameters that require them), each layer is checkpointed: its
    activations are recomputed in the backward pass.  DTensor inputs give
    the rank's rows as a DTensor sharded like the tokens."""
    ctx, params, tokens = _enter(params, tokens)
    return spmd.leave(_hidden_aux(params, tokens, cfg, _dims(ctx))[0], ctx)


def _dims(ctx) -> Tuple[int, ...]:
    return ctx.batch_dims if ctx is not None else ()


def forward(params: ParamTree, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) -> (logits (B, S, V) f32, aux): the reference's forward
    (aux the layers' mean MoE aux, 0 without MoE).  On a mesh (DTensor
    tokens or parameters) the logits are a DTensor sharded like the tokens
    and the aux a plain tensor, equal on every rank."""
    ctx, params, tokens = _enter(params, tokens)
    x, aux = _hidden_aux(params, tokens, cfg, _dims(ctx))
    return spmd.leave(_unembed(params, x, cfg), ctx), aux


def loss_fn(params: ParamTree, batch: Dict[str, torch.Tensor], cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S), plus
    ``router_aux_weight`` times the aux with MoE: a 0-d f32 tensor.  On a
    mesh each rank's mean over its rows is averaged over the batch dims:
    the same value on every rank, and gradients that sum to the whole
    batch's."""
    ctx, params, tokens = _enter(params, batch["tokens"])
    logits, aux = _hidden_aux(params, tokens, cfg, _dims(ctx))
    logits = _unembed(params, logits, cfg)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    if ctx is not None:
        loss = spmd.mean_over(loss, ctx.mesh, ctx.batch_dims)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with a KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


class _CacheView:
    """A KV cache DTensor (L, B, S, Hkv, d) seen by one rank: layer i's
    buffer over the rank's batch rows, whole in S and Hkv.  Where the cache
    rests sharded only on B (or not at all) that is the rank's block
    itself, written in place; where it is sharded on S or Hkv too (the
    reference's split-KV decode), the layer's block is gathered for the
    step and the rank's part written back after it."""

    def __init__(self, cache):
        from torch.distributed.tensor import Replicate, Shard

        self.local = cache.to_local()
        self.mesh = mesh = cache.device_mesh
        # a mesh dim of size 1 splits nothing: the rank's block is whole there
        self.layer_pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and mesh.size(i) > 1
                              else Replicate() for i, p in enumerate(cache.placements))
        self.full_pl = tuple(p if p == Shard(0) else Replicate() for p in self.layer_pl)
        self.shape = tuple(cache.shape[1:])

    @property
    def in_place(self) -> bool:
        return self.layer_pl == self.full_pl

    def layer(self, i: int) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        if self.in_place:
            return self.local[i]
        dt = DTensor.from_local(self.local[i], self.mesh, self.layer_pl, shape=self.shape,
                                stride=spmd.strides(self.shape), run_check=False)
        return dt.redistribute(self.mesh, self.full_pl).to_local()

    def write_back(self, i: int, full: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor

        if self.in_place:
            return
        dt = DTensor.from_local(full, self.mesh, self.full_pl, shape=self.shape,
                                stride=spmd.strides(self.shape), run_check=False)
        self.local[i].copy_(dt.redistribute(self.mesh, self.layer_pl).to_local())


def decode_step(
    params: ParamTree,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # (B, 1)
    cfg: TransformerConfig,
    use_kernel: bool = True,
):
    """One decode step: append the token, attend over the cache, return
    ``(logits (B, V) f32, cache)``.  The returned cache holds the same K/V
    tensors, updated in place, and a new ``len`` = ``len + 1``.
    ``use_kernel=False`` runs the plain decode attention (a comparison).

    On a mesh (DTensor tokens, cache and parameters) each rank decodes its
    batch rows against its view of the cache (:class:`_CacheView`); the
    logits come back sharded like the tokens, the cache as it was placed."""
    ctx, params, tokens = _enter(params, tokens)
    views = None
    cur = cache["len"]
    if spmd.is_dtensor(cache["k"]):
        views = _CacheView(cache["k"]), _CacheView(cache["v"])
        cur = cur.to_local() if spmd.is_dtensor(cur) else cur
    x = _embed(params, tokens, cfg)
    positions = cur.reshape(1)
    loc = cfg.layer_is_local()
    for i, layer in enumerate(_layers(params, cfg.n_layers)):
        k_i, v_i = (views[0].layer(i), views[1].layer(i)) if views else (cache["k"][i],
                                                                          cache["v"][i])
        x, _, _ = layer_forward(
            layer, x, cfg, positions, bool(loc[i]), k_cache=k_i, v_cache=v_i, cache_len=cur,
            use_kernel=use_kernel, batch_dims=_dims(ctx),
        )
        if views:
            views[0].write_back(i, k_i)
            views[1].write_back(i, v_i)
    x = rmsnorm(params["final_norm"]["scale"], x, cfg.norm_eps)
    logits = _unembed(params, x, cfg)
    new_len = cur + 1
    if spmd.is_dtensor(cache["len"]):
        new_len = spmd.leave(new_len, ctx, replicated=True)
    return spmd.leave(logits[:, 0], ctx), {"k": cache["k"], "v": cache["v"], "len": new_len}


def prefill(
    params: ParamTree,
    tokens: torch.Tensor,  # (B, S)
    cfg: TransformerConfig,
    max_len: Optional[int] = None,
):
    """Process a full prompt, building the KV cache: ``(logits of the last
    position (B, V) f32, cache)`` with ``max_len`` slots (default S).  On a
    mesh the logits and the cache's K/V are DTensors sharded on B like the
    tokens (the step builder places the cache as its rule says)."""
    ctx, params, tokens = _enter(params, tokens)
    b, s = tokens.shape
    max_len = max_len or s
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    loc = cfg.layer_is_local()
    for i, layer in enumerate(_layers(params, cfg.n_layers)):
        h = rmsnorm(layer["pre_attn_norm"]["scale"], x, cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg, positions)
        attn = _attend(q, k, v, cfg, positions, bool(loc[i]))
        x, _ = _finish(layer, x, attn, cfg, _dims(ctx))
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = rmsnorm(params["final_norm"]["scale"], x[:, -1:], cfg.norm_eps)
    cache["len"].fill_(s)
    logits = _unembed(params, x, cfg)[:, 0]
    if ctx is not None:
        cache = {"k": _leave_cache(cache["k"], ctx), "v": _leave_cache(cache["v"], ctx),
                 "len": spmd.leave(cache["len"], ctx, replicated=True)}
    return spmd.leave(logits, ctx), cache


def _leave_cache(local: torch.Tensor, ctx) -> torch.Tensor:
    """A rank's (L, B_local, S, Hkv, d) cache block as a DTensor sharded on
    B like the step's batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [Shard(1) if d in ctx.batch_dims else Replicate() for d in range(ctx.mesh.ndim)]
    return DTensor.from_local(local, ctx.mesh, pl, run_check=False)
