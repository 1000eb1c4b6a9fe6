"""Model stack of the port: the LM family's transformer, dense and MoE
(:mod:`.transformer`: serving and ``loss_fn``) on the building blocks of
:mod:`.common`, the GNN family's PNA (:mod:`.gnn`: forward, batched
molecules, ``loss_fn``, the neighbour sampler) and the recsys family's
models and losses (:mod:`.recsys`).  The mesh-bound paths wait (ROADMAP.md,
Queue 1 item 12 part 4)."""
from . import common, gnn, recsys, transformer

__all__ = ["common", "gnn", "recsys", "transformer"]
