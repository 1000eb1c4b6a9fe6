"""Launchers of the port: the serving CLI (``python -m
repro_torch.launch.serve``, :func:`repro_torch.launch.serve.main`) with its
LM back end, the shard placement of a cluster (:mod:`.mesh`), and the
recsys family's serve and retrieval steps (:mod:`.steps`)."""
from .mesh import shard_devices

__all__ = ["shard_devices"]
