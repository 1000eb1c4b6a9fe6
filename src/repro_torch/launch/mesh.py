"""Shard placement for cluster serving (port of ``shard_devices`` in
``repro.launch.mesh``; the JAX mesh builders belong to the model stack,
ROADMAP.md Queue 1 item 12)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.device import resolve_device


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


__all__ = ["shard_devices"]
