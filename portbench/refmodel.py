"""A plain PyTorch reference of the LM back end, to judge the ids it served.

The back end scores a query's 8-token window with a decoder-only
transformer (pre-norm RMSNorm with a ``1 + scale`` weight, rotary
embeddings on half-split dimensions, grouped-query causal attention with
f32 scores and softmax, a SwiGLU FFN, or a top-k mixture of experts with
GShard capacity drops beside a dense residual FFN) and answers with the
``k`` vocabulary ids of the last position's largest logits, the lower id
first among equal logits.

The configuration states bf16, so the reference computes in f32 and rounds
to bf16 wherever the configuration stores a bf16 tensor: each product's
result, each norm's output, the rotary output, the attention output, each
sum of the residual stream, the logits.  Its products are f32 sums of
bf16 operands with TF32 off; the program's are the tensor cores' f32 sums,
so the two agree to the rounding of a sum.  ``mode="fp8"`` is the control:
the operands of every bf16 product are rounded to float8 e4m3 (a scale per
tensor, amax to 448) first, the precision below the configuration's.

The expert layer routes each token by an f32 softmax over the experts (the
router's product in f32), keeps the top k (the lower expert first among
ties) with their probabilities renormalised, orders the (token, choice)
slots by expert, keeping token order, and lets each expert take only its
first ``cap = min(max(ceil(cf * T * k / E / 8) * 8, 8), T * k)`` slots of
the call's T tokens; a dropped slot adds nothing.  So a row's answer
depends on the rows that share its call, and the reference is given the
whole call, the back end's padding rows (zero token windows up to the next
power of two) included.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    """The model of config ``m`` (the configuration file's ``model``) on
    the weights ``w`` (name -> bf16 tensor, the benchmark's draw)."""

    def __init__(self, m: dict, w: dict, mode: str = "bf16"):
        if mode not in ("bf16", "fp8"):
            raise ValueError(mode)
        self.m, self.w, self.mode = m, w, mode
        #: set to a list to collect each expert layer's routing margins
        #: (rows, positions), for diagnosis
        self.margins = None

    def _op(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.mode == "fp8" else x

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _bf(self._op(x) @ self._op(w.float()))

    def _norm(self, scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.m["norm_eps"])
        return _bf(y * (1.0 + scale.float()))

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        exponent = torch.arange(0, hd, 2, dtype=torch.float32) / hd
        freqs = (1.0 / torch.pow(torch.tensor(self.m["rope_theta"], dtype=torch.float32),
                                 exponent)).to(x.device)
        ang = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)[:, None] * freqs
        sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return _bf(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1))

    def _attention(self, i: int, h: torch.Tensor) -> torch.Tensor:
        m, w = self.m, self.w
        n, s, _ = h.shape
        hq, hk, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        q = self._mm(h, w["layers.attn.q"][i])
        k = self._mm(h, w["layers.attn.k"][i])
        v = self._mm(h, w["layers.attn.v"][i])
        if m["qkv_bias"]:
            q = _bf(q + w["layers.attn.q_bias"][i].float())
            k = _bf(k + w["layers.attn.k_bias"][i].float())
            v = _bf(v + w["layers.attn.v_bias"][i].float())
        q = self._rope(q.reshape(n, s, hq, hd))
        k = self._rope(k.reshape(n, s, hk, hd))
        v = v.reshape(n, s, hk, hd)
        kv_of_head = torch.arange(hq, device=h.device) // (hq // hk)
        k, v = k[:, :, kv_of_head], v[:, :, kv_of_head]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1)
        out = _bf(torch.einsum("bhqk,bkhd->bqhd", probs, v)).reshape(n, s, hq * hd)
        return self._mm(out, w["layers.attn.o"][i])

    def _ffn(self, wi: torch.Tensor, wo: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gate, up = self._mm(h, wi).chunk(2, dim=-1)
        return self._mm(_bf(_bf(F.silu(gate)) * up), wo)

    def _moe(self, i: int, h: torch.Tensor) -> torch.Tensor:
        m, w = self.m, self.w
        e, k = m["n_experts"], m["top_k"]
        x = h.reshape(-1, h.shape[-1])
        t = x.shape[0]
        probs = torch.softmax(x @ w["layers.moe.router"][i].float(), dim=-1)
        ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
        experts = ranked.indices[:, :k]
        if self.margins is not None:
            # the log-probability by which the k-th expert beat the next
            top = ranked.values[:, k - 1:k + 1].clamp(min=1e-30).log()
            self.margins.append((top[:, 0] - top[:, 1]).reshape(h.shape[:2]))
        gw = probs.gather(-1, experts)
        gw = _bf(gw / gw.sum(-1, keepdim=True).clamp(min=1e-9))
        cap = min(max(math.ceil(m["capacity_factor"] * t * k / e / 8) * 8, 8), t * k)
        flat = experts.reshape(-1)
        y = torch.zeros(t * k, x.shape[1], device=x.device)
        wi, wo = w["layers.moe.wi"][i], w["layers.moe.wo"][i]
        for ex in range(e):
            slots = torch.nonzero(flat == ex).flatten()[:cap]
            if len(slots):
                y[slots] = self._ffn(wi[ex].reshape(wi.shape[1], -1), wo[ex], x[slots // k])
        out = _bf((_bf(y.reshape(t, k, -1) * gw[..., None])).sum(1))
        return out.reshape(h.shape)

    @torch.no_grad()
    def last_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(n, V) f32 logits (bf16 values) of each window's last position."""
        m, w = self.m, self.w
        x = w["embed"][tokens.long()].float()
        for i in range(m["n_layers"]):
            h = self._norm(w["layers.pre_attn_norm.scale"][i], x)
            x = _bf(x + self._attention(i, h))
            h = self._norm(w["layers.pre_mlp_norm.scale"][i], x)
            if m.get("n_experts"):
                y = self._moe(i, h)
                if m.get("dense_residual_ff"):
                    y = _bf(y + self._ffn(w["layers.mlp.wi"][i], w["layers.mlp.wo"][i], h))
            else:
                y = self._ffn(w["layers.mlp.wi"][i], w["layers.mlp.wo"][i], h)
            x = _bf(x + y)
        x = self._norm(w["final_norm.scale"], x[:, -1])
        return self._mm(x, w["lm_head"])


def row_gaps(logits: torch.Tensor, served: torch.Tensor):
    """Each row's widest gap by which a served id's reference logit lies
    below the reference's logit of the same rank: the max over ranks r of
    ``sorted(logits)[r] - logits[served[r]]`` (0 when the ids are the
    reference's best, in order up to equal logits), as a numpy array."""
    k = served.shape[1]
    best = torch.sort(logits, dim=-1, descending=True).values[:, :k]
    got = logits.gather(-1, served.long())
    return (best - got).amax(dim=1).float().cpu().numpy()


def widest_gap(logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest of :func:`row_gaps`."""
    return float(row_gaps(logits, served).max())


def top_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The k best ids of each row, the lower id first among equal logits."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
