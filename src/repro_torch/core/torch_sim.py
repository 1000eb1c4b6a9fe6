"""Reuse distances from a previous-occurrence array, numpy in and out.

LRU caches obey the Mattson stack-inclusion property: a request hits an LRU
of capacity C iff fewer than C distinct keys were requested since the
previous occurrence of the same key.  The reuse distance of every position
therefore gives, in one pass, the exact hit count of every capacity.

The port of ``repro.core.jax_sim``.  The reference walks the stream with a
``lax.scan`` over a heap-layout segment tree, one step per position; in
eager torch that would be one round of launches per request.  Here
:func:`reuse_distances` runs the sort-and-rank decomposition of
:mod:`repro_torch.core.rd_offline` on ``device`` instead: the same function,
a few sorts and ``searchsorted`` calls per tree level.
:func:`reuse_distances_py` is the reference's Fenwick-tree oracle, copied.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .rd_offline import reuse_distances_offline


def reuse_distances(prev: np.ndarray, device="cuda") -> np.ndarray:
    """prev-occurrence array -> reuse distances (int64, -1 for first
    occurrences), computed on ``device``."""
    dev = resolve_device(device)
    if len(prev) == 0:
        return np.zeros(0, dtype=np.int64)
    t = torch.from_numpy(np.asarray(prev, dtype=np.int64)).to(dev)
    return reuse_distances_offline(t).cpu().numpy()


def reuse_distances_py(prev: np.ndarray) -> np.ndarray:
    """Pure-python Fenwick reference (oracle for the engine above)."""
    n = len(prev)
    tree = [0] * (n + 1)

    def add(i, v):
        i += 1
        while i <= n:
            tree[i] += v
            i += i & (-i)

    def pref(i):  # sum over [0, i)
        s = 0
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        return s

    rd = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        j = int(prev[i])
        if j >= 0:
            rd[i] = pref(i) - pref(j + 1)
            add(j, -1)
        add(i, 1)
    return rd
