"""Offline reuse distances with sorts and rank queries, on any torch device.

A port of ``repro.core.rd_offline`` (numpy) to torch tensors; the result is
the reference's integer for integer.  All positions are 0-based and ``j =
prev[i]`` is the previous occurrence of the key at ``i``:

    rd(i) = #distinct keys strictly between j and i
          = #{p in (j, i) : next(p) >= i}
          = A(i) - B(i)
    A(i)  = #{p < i  : next(p) >= i} = #distinct keys in [0, i)
    B(i)  = #{p <= j : next(p) >= i}

``A`` is an exclusive prefix sum of first-occurrence flags.  ``B`` is a
dominance count over the points ``(p, next(p))``, answered with a
merge-sort tree: level ``l`` holds the next-values sorted within blocks of
``2^l``; the prefix ``[0, j]`` splits into one canonical block per set bit
of ``j + 1``, and the count of values ``>= i`` in a block is a rank query.
Packing ``block * stride + value`` makes the whole level one sorted array,
so each level is one ``torch.sort`` and one ``torch.searchsorted`` for
every query that uses it.  The four smallest levels gather and compare
instead (blocks of at most 8).

On the card every step is a sort, a ``searchsorted``, a prefix sum or a
gather: at ``2^28`` padded positions an int64 array is 2.15 GB, so each
level builds its packed keys from ``arange >> level`` on the fly and frees
them before the next.
"""
from __future__ import annotations

import torch

#: levels below this gather and compare (blocks of at most 8 positions)
DIRECT_LEVELS = 4


def _ceil_log2(n: int) -> int:
    d = 0
    while (1 << d) < n:
        d += 1
    return d


def reuse_distances_offline(prev: torch.Tensor) -> torch.Tensor:
    """prev-occurrence array -> reuse distances (-1 for first occurrences),
    int64 on ``prev``'s device."""
    dev = prev.device
    n = len(prev)
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    prev = prev.to(torch.int64)
    first = prev < 0
    repeat_pos = torch.nonzero(~first).squeeze(1)  # the queries' i, ascending
    qx = prev[repeat_pos]

    d = max(_ceil_log2(n), 1)
    n_pad = 1 << d
    # y[p] = next(p): the next occurrence of the key at p, n if none; the
    # pads' -1 never satisfies next >= i (i >= 1 for any repeat)
    y_pad = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
    y_pad[:n] = n
    y_pad[qx] = repeat_pos

    # A(i) at the repeats: an exclusive prefix sum of the first flags
    a = torch.cumsum(first, 0)
    a -= first.to(torch.int64)
    rd_rep = a[repeat_pos]
    del a, first

    r = qx + 1  # prefix length to decompose
    del qx
    stride = n_pad + 2
    for lvl in range(d + 1):
        use = torch.nonzero((r >> lvl) & 1).squeeze(1)
        if len(use) == 0:
            continue
        size = 1 << lvl
        # canonical block (in units of 2^lvl) covering this prefix segment
        block = (r[use] >> (lvl + 1)) << 1
        qy = repeat_pos[use]
        if lvl < DIRECT_LEVELS:
            start = block << lvl
            cnt = torch.zeros(len(use), dtype=torch.int64, device=dev)
            for off in range(size):
                cnt += y_pad[start + off] >= qy
            rd_rep.index_add_(0, use, -cnt)
            continue
        flat = torch.arange(n_pad, dtype=torch.int64, device=dev)
        flat >>= lvl
        flat *= stride
        flat += y_pad
        # one sorted array for the level: blocks ascend, so sorting the
        # packed keys sorts each block's values in place
        flat = torch.sort(flat).values
        pos = torch.searchsorted(flat, block * stride + qy, right=False)
        del flat
        # B += size - (pos - block * size): the block's values >= i
        pos -= block * size
        pos -= size
        rd_rep.index_add_(0, use, pos)
        del pos, block, qy, use
    rd = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rd[repeat_pos] = rd_rep
    return rd
