"""Launchers of the port: the serving CLI (``python -m
repro_torch.launch.serve``, :func:`repro_torch.launch.serve.main`) with its
LM back end, the training CLI (``python -m repro_torch.launch.train``), the
meshes and shard placement (:mod:`.mesh`), the sharding rules
(:mod:`.shardings`), the step builders on one device or a mesh
(:mod:`.steps`: ``build_step`` -> ``StepBundle``) and the dry-run of every
cell on the production meshes (``python -m repro_torch.launch.dryrun``)."""
from .mesh import (
    batch_axes,
    make_production_mesh,
    make_smoke_mesh,
    mesh_device_count,
    shard_devices,
)
from .steps import StepBundle, build_step, input_specs

__all__ = [
    "StepBundle",
    "batch_axes",
    "build_step",
    "input_specs",
    "make_production_mesh",
    "make_smoke_mesh",
    "mesh_device_count",
    "shard_devices",
]
