"""Step builders of the recsys family: the serving half of
``repro.launch.steps`` (``_recsys_fns``, ``build_recsys_step``).

For each recsys architecture, the serve function (a batch of users or
histories against one target each) and the retrieval function (one query
against ``n_candidates`` items), with makers of seeded batches of real ids
at a shape's sizes.  The reference's makers build ``ShapeDtypeStruct``s for
its dry-run; the port's draw data from a ``torch.Generator``:

* ids are uniform over the table they index;
* each multi-hot bag (two-tower's user and item features) has a length
  uniform in ``1 .. L``, its ids first and -1 pads after them;
* histories (SASRec, DIN, MIND) are full.

No mesh and no sharding (they wait with ``shardings.py`` and ``mesh.py``),
and no training step: ROADMAP.md, Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import torch

from ..configs.registry import Arch, ShapeSpec
from ..core.device import resolve_device
from ..models import recsys

#: two-tower's multi-hot bag lengths: user features and item features
_USER_BAG = 8
_ITEM_BAG = 4

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class RecsysStep:
    #: ``fn(batch)`` -> scores; two-tower's also takes ``use_kernel``
    fn: Callable[..., torch.Tensor]
    batch: Batch


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


RECSYS_INIT = {
    "two-tower-retrieval": recsys.init_two_tower,
    "sasrec": recsys.init_sasrec,
    "din": recsys.init_din,
    "mind": recsys.init_mind,
}


def build_recsys_step(arch: Arch, shape: ShapeSpec, params, generator: torch.Generator,
                      device="cuda", smoke: bool = False) -> RecsysStep:
    """The ``serve`` or ``retrieval`` step of ``arch`` at ``shape`` (batch 64
    and 4096 candidates with ``smoke``, as the reference's smoke runs), bound
    to ``params``, with a batch drawn from ``generator`` and moved to
    ``device``."""
    dev = resolve_device(device)
    if arch.family != "recsys":
        raise ValueError(f"{arch.name} is not a recsys architecture")
    if shape.kind == "train":
        raise NotImplementedError(
            "recsys training is not ported yet (ROADMAP.md, Queue 1 item 12)")
    cfg = arch.smoke_config if smoke else arch.config
    serve_fn, retr_fn, make_serve, make_retr = recsys_fns(arch, cfg)
    if shape.kind == "serve":
        fn, batch = serve_fn, make_serve(64 if smoke else shape.dims["batch"], generator)
    elif shape.kind == "retrieval":
        fn, batch = retr_fn, make_retr(4096 if smoke else shape.dims["n_candidates"], generator)
    else:
        raise ValueError(f"unknown step kind {shape.kind!r}")
    batch = {k: t.to(dev) for k, t in batch.items()}
    return RecsysStep(functools.partial(fn, params), batch)
