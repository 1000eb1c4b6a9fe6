"""Launchers of the port: the serving CLI (``python -m
repro_torch.launch.serve``, :func:`repro_torch.launch.serve.main`) with its
LM back end, the training CLI (``python -m repro_torch.launch.train``), the
shard placement of a cluster (:mod:`.mesh`), and the LM, GNN and recsys
step builders (:mod:`.steps`)."""
from .mesh import shard_devices

__all__ = ["shard_devices"]
