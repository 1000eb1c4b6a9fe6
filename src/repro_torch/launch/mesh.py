"""Meshes and shard placement: the port of ``repro.launch.mesh``.

The mesh builders return a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names:

* single-pod : (data=16, model=16)
* multi-pod  : (pod=P, data=16, model=16) -- "pod" composes with "data" for
  batch sharding, "model" stays inside a pod.

Importing this module touches no process state.  A ``DeviceMesh`` needs a
default process group: when none exists and the mesh has one rank, the
builders set up a world of one from an in-memory store (``HashStore``, no
network): ``nccl`` on ``cuda``, ``gloo`` on the CPU.  A larger mesh needs a
world of that many ranks already set up, by the caller's launcher, or by
the dry-run's fake group (``python -m repro_torch.launch.dryrun``).

:class:`AbstractMesh` is a mesh of names and sizes only (the reference's
``jax.sharding.AbstractMesh``): the sharding rules take it where no group
of that size exists.  :func:`shard_devices` places a cluster's shard
brokers on cards.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.device import resolve_device


class AbstractMesh:
    """Axis names and sizes without devices, as ``jax.sharding.AbstractMesh``:
    ``shape`` maps each axis name to its size, in mesh order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} axes")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _device_type(device) -> str:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else 0)
    return dev.type


def ensure_world(n_ranks: int, device="cuda") -> None:
    """A default process group of ``n_ranks``: the one that exists, or a
    world of one from a ``HashStore`` (``nccl`` on the card, ``gloo`` on the
    CPU) when ``n_ranks`` is 1.  Raises when no group of that size can be
    had here."""
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise RuntimeError(
                f"a mesh of {n_ranks} ranks needs a world of {n_ranks}; this process's "
                f"group has {dist.get_world_size()}")
        return
    if n_ranks != 1:
        raise RuntimeError(
            f"a mesh of {n_ranks} ranks needs a process group of {n_ranks} ranks: start one "
            f"per rank with a launcher, or check placements without devices on the dry-run's "
            f"fake group (python -m repro_torch.launch.dryrun)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
                            rank=0, world_size=1, **kw)


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device):
    from torch.distributed.device_mesh import init_device_mesh

    kind = _device_type(device)
    ensure_world(math.prod(shape), device)
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, n_pods: int = 2, device="cuda"):
    """(data=16, model=16), or (pod=n_pods, data=16, model=16): a world of
    256 or 512 ranks."""
    shape = (n_pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_smoke_mesh(shape: Tuple[int, ...] = (1, 1), axes=("data", "model"), device="cuda"):
    """A small mesh (one rank by default) for smoke runs and tests."""
    return _make_mesh(tuple(shape), tuple(axes), device)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes over which the global batch shards."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in axis_names(mesh) else None


def mesh_device_count(mesh) -> int:
    return int(math.prod(axis_sizes(mesh).values()))


def shard_devices(n_shards: int, devices: Optional[Sequence] = None, device="cuda") -> list:
    """Round-robin shard -> device placement for cluster serving.

    Shard broker ``i`` of a :class:`repro_torch.serving.cluster.Cluster`
    builds its cache on ``devices[i % len(devices)]``.  With fewer devices
    than shards, shards wrap (several brokers share a device); with one
    card every shard lands on ``cuda:0``.  ``devices`` defaults to every
    card, ``torch.device("cuda", i)`` for ``i < torch.cuda.device_count()``,
    when ``device`` is ``"cuda"``; to ``[device]`` when it names one card
    (``"cuda:1"``) or the CPU.  Asking for the card without one raises.
    """
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    devs = list(devices)
    if not devs:
        raise ValueError("no devices available for shard placement")
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return [devs[i % len(devs)] for i in range(n)]


__all__ = [
    "AbstractMesh",
    "axis_sizes",
    "batch_axes",
    "ensure_world",
    "make_production_mesh",
    "make_smoke_mesh",
    "mesh_device_count",
    "model_axis",
    "shard_devices",
]
