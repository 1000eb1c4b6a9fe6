"""Architecture registry: the port of ``repro.configs.registry``.

The five LM architectures, PNA (the GNN family) and the four recsys
architectures with their full published configurations, their reduced
smoke configurations (CPU-runnable) and their input shapes, as the
reference has them, with torch dtypes, and :func:`all_cells`, the 40
(arch, shape) pairs of the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..models.gnn import PNAConfig
from ..models.recsys import DINConfig, MINDConfig, SASRecConfig, TwoTowerConfig
from ..models.transformer import MoEConfig, TransformerConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode" | "serve" | "retrieval"
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # "lm" | "gnn" | "recsys"
    config: Any
    smoke_config: Any
    shapes: Tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}")


LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)


def _lm_smoke(**over) -> TransformerConfig:
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        dtype=torch.float32,
        q_chunk=None,
        remat=False,
    )
    base.update(over)
    return TransformerConfig(**base)


GEMMA2_27B = Arch(
    name="gemma2-27b",
    family="lm",
    # [arXiv:2408.00118; HF google/gemma-2-27b] local/global alternating,
    # attn+final logit softcaps, GQA 32q/16kv, head_dim 128 with
    # query scale (d_model/n_heads)^-0.5 = 144^-0.5, GeGLU, tied embeddings.
    config=TransformerConfig(
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864 // 2,  # HF intermediate 36864 counts gate+up fused
        vocab_size=256_000,
        activation="gelu",
        attn_pattern="local_global",
        window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        query_scale=(4608 / 32) ** -0.5,
    ),
    smoke_config=_lm_smoke(
        attn_pattern="local_global",
        window=16,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        activation="gelu",
    ),
    shapes=LM_SHAPES,
    notes="long_500k runs as decode (O(S) per step); local layers window=4096.",
)

GEMMA_2B = Arch(
    name="gemma-2b",
    family="lm",
    # [arXiv:2403.08295; HF google/gemma-2b] MQA (kv=1), head_dim 256,
    # GeGLU, tied embeddings, embedding scaling.
    config=TransformerConfig(
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256_000,
        activation="gelu",
        embed_scale=True,
        tie_embeddings=True,
    ),
    smoke_config=_lm_smoke(
        n_kv_heads=1, activation="gelu", embed_scale=True, tie_embeddings=True
    ),
    shapes=LM_SHAPES,
)

GLM4_9B = Arch(
    name="glm4-9b",
    family="lm",
    # [HF THUDM/glm-4-9b] GQA 32q/2kv, qkv bias, SwiGLU, RoPE.
    config=TransformerConfig(
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=151_552,
        activation="silu",
        qkv_bias=True,
    ),
    smoke_config=_lm_smoke(qkv_bias=True),
    shapes=LM_SHAPES,
)

LLAMA4_SCOUT = Arch(
    name="llama4-scout-17b-a16e",
    family="lm",
    # [HF meta-llama/Llama-4-Scout-17B-16E; unverified] MoE 16 experts
    # top-1 + shared expert (dense residual), GQA 40q/8kv.
    config=TransformerConfig(
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        activation="silu",
        moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, dense_residual_ff=8192),
    ),
    smoke_config=_lm_smoke(
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=64, dense_residual_ff=64)
    ),
    shapes=LM_SHAPES,
    notes="NoPE-every-4th-layer of the release is not modeled (RoPE throughout).",
)

ARCTIC_480B = Arch(
    name="arctic-480b",
    family="lm",
    # [HF Snowflake/snowflake-arctic-base] dense-MoE hybrid: every layer has
    # a dense residual FFN (4864) in parallel with a 128-expert top-2 MoE.
    config=TransformerConfig(
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32_000,
        activation="silu",
        moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, dense_residual_ff=4864),
    ),
    smoke_config=_lm_smoke(
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, dense_residual_ff=64)
    ),
    shapes=LM_SHAPES,
)

# ---------------------------------------------------------------------------
# GNN: PNA
# ---------------------------------------------------------------------------

PNA = Arch(
    name="pna",
    family="gnn",
    # [arXiv:2004.05718] 4 layers, width 75, aggregators mean/max/min/std,
    # scalers identity/amplification/attenuation.
    config=PNAConfig(n_layers=4, d_hidden=75, d_in=1433, n_classes=64),
    smoke_config=PNAConfig(n_layers=2, d_hidden=16, d_in=24, n_classes=8),
    shapes=(
        ShapeSpec("full_graph_sm", "train", {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
        ShapeSpec(
            "minibatch_lg",
            "train",
            # fanout 15-10 from 1024 seeds: block bounded by
            # 1024*(1 + 15 + 150) nodes and 1024*(15+150) edges
            {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
             "fanout0": 15, "fanout1": 10,
             "block_nodes": 1024 * (1 + 15 + 150), "block_edges": 1024 * (15 + 150),
             "d_feat": 602},
        ),
        ShapeSpec("ogb_products", "train", {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
        ShapeSpec("molecule", "serve", {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 64}),
    ),
    notes=(
        "Result caching applies to the molecule (request-stream) shape; "
        "full-graph shapes are single mega-requests (see DESIGN.md §5)."
    ),
)

# ---------------------------------------------------------------------------
# RecSys (shapes shared across the 4 recsys archs)
# ---------------------------------------------------------------------------

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65_536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)

TWO_TOWER = Arch(
    name="two-tower-retrieval",
    family="recsys",
    # [Yi et al. RecSys'19 (YouTube); unverified] 256-dim embeddings,
    # towers 1024-512-256, dot-product interaction, in-batch softmax.
    config=TwoTowerConfig(n_users=8_000_000, n_items=4_000_000),
    smoke_config=TwoTowerConfig(
        n_users=1000, n_items=500, embed_dim=16, tower_dims=(32, 16)
    ),
    shapes=RECSYS_SHAPES,
)

SASREC = Arch(
    name="sasrec",
    family="recsys",
    # [arXiv:1808.09781] embed 50, 2 blocks, 1 head, seq 50.
    config=SASRecConfig(n_items=2_000_000),
    smoke_config=SASRecConfig(n_items=500, embed_dim=16, n_blocks=1, seq_len=10, d_ff=32),
    shapes=RECSYS_SHAPES,
)

DIN = Arch(
    name="din",
    family="recsys",
    # [arXiv:1706.06978] embed 18, seq 100, attn MLP 80-40, MLP 200-80.
    config=DINConfig(n_items=10_000_000),
    smoke_config=DINConfig(n_items=500, embed_dim=8, seq_len=12, attn_dims=(16, 8), mlp_dims=(32, 16)),
    shapes=RECSYS_SHAPES,
)

MIND_ARCH = Arch(
    name="mind",
    family="recsys",
    # [arXiv:1904.08030; unverified] embed 64, 4 interests, 3 routing iters.
    config=MINDConfig(n_items=4_000_000),
    smoke_config=MINDConfig(n_items=500, embed_dim=16, n_interests=2, capsule_iters=2, seq_len=10),
    shapes=RECSYS_SHAPES,
)

ARCHS: Dict[str, Arch] = {
    a.name: a
    for a in (
        GEMMA2_27B, GEMMA_2B, GLM4_9B, LLAMA4_SCOUT, ARCTIC_480B, PNA,
        TWO_TOWER, SASREC, DIN, MIND_ARCH,
    )
}

def get_arch(name: str) -> Arch:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every (arch, shape) pair -- the 40 dry-run cells."""
    for arch in ARCHS.values():
        for shape in arch.shapes:
            yield arch, shape
