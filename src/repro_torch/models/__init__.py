"""Model stack of the port: the LM family's transformer, dense and MoE
(:mod:`.transformer`: serving and ``loss_fn``, the shard-local MoE and the
sequence-parallel residual on a mesh) on the building blocks of
:mod:`.common`, the GNN family's PNA (:mod:`.gnn`: forward, batched
molecules, ``loss_fn``, ``forward_dist``, the neighbour sampler), the
recsys family's models and losses (:mod:`.recsys`), and the SPMD helpers
that run them on DTensor inputs (:mod:`.spmd`)."""
from . import common, gnn, recsys, spmd, transformer

__all__ = ["common", "gnn", "recsys", "spmd", "transformer"]
