"""Seeded random weights, drawn on the device in a few large calls.

One flat bf16 buffer is filled from a ``torch.Generator`` seeded with the
run's seed, a chunk of at most ``CHUNK`` values per call, and cut into the
model's tensors, each scaled to its init's standard deviation (the
fan-in's inverse square root; 1 for the embedding).  Norm scales and
biases are zeros, and the router is f32, as the model initialises them.
The names are the model's parameter tree's, flattened with dots; the
benchmark hands the program its tree of these tensors and the reference
the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30


def layout(m: dict) -> List[Tuple[str, tuple, float, torch.dtype]]:
    """``(name, shape, std, dtype)`` of every tensor; std 0 is zeros."""
    d, hd, nl = m["d_model"], m["head_dim"], m["n_layers"]
    hq, hk = m["n_heads"], m["n_kv_heads"]
    bf, f32 = torch.bfloat16, torch.float32
    out = [
        ("embed", (m["vocab_size"], d), 1.0, bf),
        ("layers.attn.q", (nl, d, hq * hd), d**-0.5, bf),
        ("layers.attn.k", (nl, d, hk * hd), d**-0.5, bf),
        ("layers.attn.v", (nl, d, hk * hd), d**-0.5, bf),
        ("layers.attn.o", (nl, hq * hd, d), (hq * hd) ** -0.5, bf),
        ("layers.pre_attn_norm.scale", (nl, d), 0.0, bf),
        ("layers.pre_mlp_norm.scale", (nl, d), 0.0, bf),
        ("final_norm.scale", (d,), 0.0, bf),
        ("lm_head", (d, m["vocab_size"]), d**-0.5, bf),
    ]
    if m["qkv_bias"]:
        out += [("layers.attn.q_bias", (nl, hq * hd), 0.0, bf),
                ("layers.attn.k_bias", (nl, hk * hd), 0.0, bf),
                ("layers.attn.v_bias", (nl, hk * hd), 0.0, bf)]
    ff = m["d_ff"]
    if m.get("n_experts"):
        e, fe = m["n_experts"], m["expert_d_ff"]
        out += [("layers.moe.router", (nl, d, e), d**-0.5, f32),
                ("layers.moe.wi", (nl, e, d, 2, fe), d**-0.5, bf),
                ("layers.moe.wo", (nl, e, fe, d), fe**-0.5, bf)]
        ff = m.get("dense_residual_ff", 0)
    if ff:
        out += [("layers.mlp.wi", (nl, d, 2 * ff), d**-0.5, bf),
                ("layers.mlp.wo", (nl, ff, d), ff**-0.5, bf)]
    return out


def make(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of config ``m`` from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [(n, s, std) for n, s, std, dt in layout(m) if dt == dtype and std > 0]
        total = sum(math.prod(s) for _, s, _ in leaves)
        flat = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        at = 0
        for name, shape, std in leaves:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
    for name, shape, std, dtype in layout(m):
        if std == 0:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def tree(w: Dict[str, torch.Tensor]) -> dict:
    """The nested parameter tree of the flat names."""
    root: dict = {}
    for name, t in w.items():
        node = root
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return root
