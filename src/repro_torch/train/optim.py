"""AdamW and Adafactor on trees of tensors: the port of
``repro.train.optim``.

Optimizer state is kept in f32 whatever the parameter dtype (mixed
precision training: bf16 params / f32 moments), with optional global-norm
clipping and decoupled weight decay.  Each update is computed in f32 in the
reference's order of operations and cast back to the parameter's dtype.

A tree is a nested dict or list of tensors, or a transformer's
``ParamTree`` (its ``tree()``); leaves are taken in the reference's order
(``repro_torch.models.common.tree_leaves``), so the global norm sums them
as the reference does.  The step counter is a 0-d int32 tensor on the
parameters' device, and the schedule's scalars are computed there: an
update makes no host sync.

Unlike the reference, whose arrays are immutable, :func:`apply_updates`
and :func:`adafactor_updates` update the parameters, the gradients
(clipped in place) and the state **in place**, and return them: at
two-tower's full width a functional update would hold a second copy of
the 12.3 GB of parameters and of the 24.6 GB of moments.  A caller that
needs the old values clones them first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..models.common import global_norm, tensor_from_numpy, tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Params  # first moment (f32)
    nu: Params  # second moment (f32)


def _device_of(params: Params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def init_opt_state(params: Params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, optional momentum-free) for 100B+ models:
# AdamW's two f32 moments are 8 bytes/param; factored row/col statistics
# cut that to ~0 (Shazeer & Stern, arXiv:1804.04235).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8  # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 100


class FactoredState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    #: per-leaf: dict with "row"/"col" (factored) or "full" (vectors)
    stats: Params


def _factored_shape(shape) -> Tuple[Tuple[int, ...], bool]:
    """View used for row/col factoring.

    Adafactor factors the last two axes.  A tiny penultimate axis (e.g. the
    gate/up axis of the fused MoE wi: (L, E, D, 2, F)) would make the "col"
    statistic nearly as large as the parameter itself -- merge such axes
    into their neighbour so the factored pair is (D*2, F).
    """
    shape = tuple(shape)
    if len(shape) >= 3 and shape[-2] < 8:
        shape = shape[:-3] + (shape[-3] * shape[-2], shape[-1])
    return shape, len(shape) >= 2


def init_adafactor_state(params: Params) -> FactoredState:
    def init_leaf(p):
        view, factored = _factored_shape(p.shape)
        if factored:
            return {
                "row": torch.zeros(view[:-1], dtype=torch.float32, device=p.device),
                "col": torch.zeros(view[:-2] + view[-1:], dtype=torch.float32, device=p.device),
            }
        return {"full": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    return FactoredState(
        step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        stats=tree_map(init_leaf, params),
    )


@torch.no_grad()
def adafactor_updates(
    params: Params, grads: Params, state: FactoredState, cfg: AdafactorConfig
) -> Tuple[Params, FactoredState]:
    """One Adafactor step, in place (module docstring)."""
    step = state.step + 1
    stepf = step.float()
    beta2 = 1.0 - stepf ** (-cfg.decay)
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    lr = cfg.lr * warm

    def upd(p, g, s):
        gf = g.float()
        view, factored = _factored_shape(p.shape)
        g2 = gf * gf + cfg.eps
        if factored:
            g2v = g2.reshape(view)
            row = beta2 * s["row"] + (1 - beta2) * g2v.mean(dim=-1)
            col = beta2 * s["col"] + (1 - beta2) * g2v.mean(dim=-2)
            denom = row[..., None] * col[..., None, :] / torch.clamp(
                row.mean(dim=-1)[..., None, None], min=1e-30
            )
            denom = denom.reshape(p.shape)
            s["row"].copy_(row)
            s["col"].copy_(col)
        else:
            denom = beta2 * s["full"] + (1 - beta2) * g2
            s["full"].copy_(denom)
        u = gf * torch.rsqrt(torch.clamp(denom, min=1e-30))
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        pf = p.float()
        p.copy_(pf - lr * (u + cfg.weight_decay * pf))

    tree_map(upd, params, grads, state.stats)  # each leaf with its stat dict
    state.step.copy_(step)
    return params, state


@torch.no_grad()
def apply_updates(
    params: Params, grads: Params, state: OptState, cfg: AdamWConfig
) -> Tuple[Params, OptState]:
    """One AdamW step, in place (module docstring).  Each leaf runs the
    reference's f32 expressions in its order, reusing two scratch buffers
    of the leaf's size:

        m2 = b1 * m + (1 - b1) * g;  v2 = b2 * v + ((1 - b2) * g) * g
        delta = (m2 / b1c) / (sqrt(v2 / b2c) + eps) + wd * p
        p = p - lr * delta
    """
    step = state.step + 1
    g_leaves = tree_leaves(grads)
    if cfg.clip_norm is not None:
        gn = global_norm(g_leaves)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        for g in g_leaves:
            g.mul_(scale.to(g.dtype))

    lr = _schedule(cfg, state.step)
    stepf = step.float()
    b1c = 1.0 - _f32(cfg.b1, stepf) ** stepf
    b2c = 1.0 - _f32(cfg.b2, stepf) ** stepf

    for p, g, m, v in zip(tree_leaves(params), g_leaves, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        gf = g.float()
        t = gf * (1 - cfg.b1)
        m.mul_(cfg.b1).add_(t)  # m2
        torch.mul(gf, 1 - cfg.b2, out=t)
        t.mul_(gf)
        v.mul_(cfg.b2).add_(t)  # v2
        del gf
        torch.div(m, b1c, out=t)  # mhat
        u = v / b2c  # vhat
        u.sqrt_().add_(cfg.eps)
        t.div_(u)
        pf = p.float()
        torch.mul(pf, cfg.weight_decay, out=u)
        t.add_(u).mul_(lr)  # lr * delta
        del u
        if p.dtype == torch.float32:
            p.sub_(t)
        else:
            p.copy_(pf.sub_(t))
    state.step.copy_(step)
    return params, state


def opt_state_from_numpy(state, device="cuda"):
    """The port's ``OptState`` or ``FactoredState`` on ``device`` from the
    reference's (``jax.tree.map(np.asarray, state)``) or from a restored
    checkpoint's tree of arrays, bit for bit."""
    conv = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    if hasattr(state, "stats"):
        return FactoredState(step=conv(state.step), stats=tree_map(conv, state.stats))
    return OptState(step=conv(state.step), mu=tree_map(conv, state.mu), nu=tree_map(conv, state.nu))
