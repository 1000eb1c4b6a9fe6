"""Public cache ops: conflict-aware fused probe-and-commit and the
one-dispatch serve, over the packed state (port of
``repro.kernels.cache_ops.ops``).

The sequential LRU commit replays a batch one request at a time.  These
ops reproduce it bit for bit in two phases:

1. **plan** -- stable-sort the batch by set index (:func:`plan_segments`);
   each run of equal sets is a *segment* whose requests apply in arrival
   order;
2. **resolve** -- one kernel launch: each segment replays its requests on
   its set's row, probing against the pristine row and committing on the
   evolving one, then writes the row back.

State layout: the per-slot key_hi / key_lo / stamp / insertion-epoch
words live in one packed ``(S, 4W)`` array (:func:`pack_words`).  The
port holds it as ``torch.int32`` with the JAX package's uint32 bits;
unsigned words compare through an int64 view in the plain versions and as
``uint32_t`` in the kernels.

Differences from the JAX ops, none of them visible in the results:

* the kernels read the request fields through the sort permutation and
  write every per-request output at its arrival position, so there is no
  sorted copy of the batch and no un-sort pass;
* the effective-epoch fold (a pristine *fresh* hit keeps its resident
  epoch, ``ops.py:286-292`` of the reference) runs per request inside the
  kernel, against the pristine row it already holds;
* ``ks`` and the value table are updated **in place** and returned: the
  broker owns its state.  Callers that need the input afterwards clone it.

Requests carrying the reserved pad key (``(PAD_HI, PAD_LO)``, all-ones
words) are inert: never a hit, never admitted, never an eviction.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .kernel import probe_and_commit as _probe_and_commit
from .ref import conflict_round
from .serve_kernel import serve_fused as _serve_fused

#: words packed per cache slot: key_hi, key_lo, stamp, insertion epoch
PACKED_WORDS = 4
#: the reserved pad key's hash words (uint32); as int32 bits both are -1
PAD_HI = 0xFFFFFFFF
PAD_LO = 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def pack_words(key_hi, key_lo, stamp, epoch=None) -> torch.Tensor:
    """Pack per-slot (key_hi, key_lo, stamp[, epoch]) int32-bit tensors into
    one ``(..., 4W)`` int32 tensor.  ``epoch`` defaults to zeros."""
    if epoch is None:
        epoch = torch.zeros_like(key_hi)
    return torch.cat([_i32(key_hi), _i32(key_lo), _i32(stamp), _i32(epoch)], dim=-1)


def unpack_words(ks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(..., 4W)`` packed words -> (key_hi, key_lo, stamp) views."""
    w = ks.shape[-1] // PACKED_WORDS
    return ks[..., :w], ks[..., w : 2 * w], ks[..., 2 * w : 3 * w]


def unpack_epoch(ks: torch.Tensor) -> torch.Tensor:
    """``(..., 4W)`` packed words -> the insertion-epoch view."""
    w = ks.shape[-1] // PACKED_WORDS
    return ks[..., 3 * w :]


def plan_segments(set_idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Describe the per-set conflict structure of a batch.

    Returns int32 ``(order, seg_id, leader, seg_len, seg_set)``: a stable
    sort permutation grouping equal sets while preserving arrival order,
    the segment id of each sorted item, and per segment (padded to B with
    ``leader == B`` / ``seg_len == 0``) its first sorted position, length
    and set.
    """
    b = set_idx.shape[0]
    dev = set_idx.device
    order = torch.argsort(set_idx, stable=True)  # ties keep arrival order
    sset = set_idx[order]
    start = torch.ones(b, dtype=torch.bool, device=dev)
    start[1:] = sset[1:] != sset[:-1]
    seg_id = torch.cumsum(start, dim=0) - 1
    arange = torch.arange(b, device=dev)
    leader = torch.full((b,), b, dtype=torch.int64, device=dev)
    leader.scatter_reduce_(0, seg_id, arange, reduce="amin")
    seg_len = torch.zeros(b, dtype=torch.int64, device=dev)
    seg_len.scatter_add_(0, seg_id, torch.ones_like(seg_id))
    seg_set = sset[leader.clamp(max=b - 1)]  # padded slots repeat the last set
    return tuple(_i32(x) for x in (order, seg_id, leader, seg_len, seg_set))


def resolve_conflicts(
    rows_hi: torch.Tensor,  # (B, W) one pristine row per segment
    rows_lo: torch.Tensor,
    rows_st: torch.Tensor,
    rows_ep: torch.Tensor,  # (B, W) insertion epochs (uint32 bits)
    s_hi: torch.Tensor,  # (B,) sorted request fields
    s_lo: torch.Tensor,
    s_pos: torch.Tensor,  # original batch positions (stamps follow arrival)
    s_admit: torch.Tensor,
    s_static: torch.Tensor,
    s_epoch: torch.Tensor,  # (B,) insertion epoch stamped on writes
    s_minep: torch.Tensor,  # (B,) freshness floor (0 = no expiry)
    leader: torch.Tensor,
    seg_len: torch.Tensor,
    clock,
    seg_id: Optional[torch.Tensor] = None,  # (B,) sorted position -> segment
) -> Tuple[torch.Tensor, ...]:
    """The reference's vectorised rounds loop: round ``j`` applies every
    segment's ``j``-th request to its evolving row (:func:`conflict_round`)
    and records that request's write plan.  Returns ``(r_hi, r_lo, r_st,
    r_ep, wrote, way)``: the resolved rows and, per sorted position,
    whether it wrote and into which way.  ``seg_id`` (from
    :func:`plan_segments`) is recomputed from ``leader`` and ``seg_len``
    when omitted.  The kernels do this inside one launch; this function is
    the reference's building block, on any device."""
    b = rows_hi.shape[0]
    dev = rows_hi.device
    leader, seg_len = leader.to(torch.int64), seg_len.to(torch.int64)
    if seg_id is None:
        # positions covered by segment s are [leader[s], leader[s] + len[s])
        starts = torch.zeros(b + 1, dtype=torch.int64, device=dev)
        starts.index_add_(0, leader.clamp(max=b), (seg_len > 0).to(torch.int64))
        seg_id = torch.cumsum(starts[:b], dim=0) - 1
    seg_id = seg_id.to(torch.int64)
    rank = torch.arange(b, device=dev) - leader[seg_id]
    clock = torch.as_tensor(clock, device=dev).to(torch.int64)
    r_hi, r_lo, r_st, r_ep = rows_hi, rows_lo, rows_st, rows_ep
    wrote = torch.zeros(b, dtype=torch.bool, device=dev)
    way_out = torch.zeros(b, dtype=torch.int32, device=dev)
    for j in range(int(seg_len.max()) if b else 0):
        idx = (leader + j).clamp(max=b - 1)
        stamp = (clock + 1 + s_pos[idx].to(torch.int64)).to(torch.int32)  # int32 wrap
        r_hi, r_lo, r_st, r_ep, _, way, _, refresh = conflict_round(
            r_hi, r_lo, r_st, r_ep, s_hi[idx], s_lo[idx], s_admit[idx], s_static[idx],
            s_epoch[idx], s_minep[idx], stamp, j < seg_len,
        )
        # position p's plan came from this round iff its rank in its segment is j
        sel = rank == j
        wrote = torch.where(sel, refresh[seg_id], wrote)
        way_out = torch.where(sel, way[seg_id], way_out)
    return r_hi, r_lo, r_st, r_ep, wrote, way_out


def _defaults(b: int, dev, epochs, min_epoch):
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    return (
        zeros if epochs is None else _i32(epochs),
        zeros if min_epoch is None else _i32(min_epoch),
    )


def _empty_result(b: int, dev) -> Dict[str, torch.Tensor]:
    z = torch.zeros(b, dtype=torch.int32, device=dev)
    zb = torch.zeros(b, dtype=torch.bool, device=dev)
    return dict(pre_hit=zb, pre_way=z, pre_stale=zb, pre_epoch=z, wrote=zb, way=z)


def probe_and_commit_op(
    ks: torch.Tensor,  # (S, 4W) int32 packed state, updated in place
    h_hi: torch.Tensor,  # (B,) int32 request hash words (uint32 bits)
    h_lo: torch.Tensor,
    set_idx: torch.Tensor,  # (B,) int32
    admit: torch.Tensor,  # (B,) bool
    static_hit: torch.Tensor,  # (B,) bool (static-layer hits never write)
    clock: torch.Tensor,  # () int32
    epochs: Optional[torch.Tensor] = None,  # (B,) write epochs (None -> 0)
    min_epoch: Optional[torch.Tensor] = None,  # (B,) freshness floors (None -> 0)
) -> Dict[str, torch.Tensor]:
    """Fused probe + batch commit over the packed state.

    Returns ``ks`` (the same tensor, committed) plus, per request in
    arrival order: ``pre_hit``/``pre_way``/``pre_stale``/``pre_epoch`` --
    the probe outcome against the pre-commit state -- and
    ``wrote``/``way`` -- the deferred value fill plan (inserts *and* stale
    refreshes).  The caller owns the clock bump and the value scatter.
    """
    b = h_hi.shape[0]
    epochs, min_epoch = _defaults(b, ks.device, epochs, min_epoch)
    if b == 0:
        return dict(ks=ks, **_empty_result(0, ks.device))
    order, _, leader, seg_len, seg_set = plan_segments(_i32(set_idx))
    pre_hit, pre_way, pre_stale, pre_epoch, wrote, way = _probe_and_commit(
        ks, order, leader, seg_len, seg_set, _i32(h_hi), _i32(h_lo),
        admit.to(torch.bool).contiguous(), static_hit.to(torch.bool).contiguous(),
        epochs, min_epoch, _i32(clock),
    )
    return dict(
        ks=ks, pre_hit=pre_hit, pre_way=pre_way, pre_stale=pre_stale,
        pre_epoch=pre_epoch, wrote=wrote, way=way,
    )


def fill_winner_slots(
    nslots: int,
    w: int,
    f_set_idx: torch.Tensor,  # (F,) int32 deferred-fill set indices
    f_wrote: torch.Tensor,  # (F,) bool
    f_way: torch.Tensor,  # (F,) int32
) -> torch.Tensor:
    """Deduplicate a deferred-fill plan to unique last-writer slots.

    Returns per plan entry the flat value-table slot ``set * W + way`` it
    may write, or ``nslots`` (out of range: dropped) for entries that did
    not write, lost a slot collision to a later writer, or point out of
    bounds.  Unique slots make the fill order-independent.
    """
    f = f_set_idx.shape[0]
    dev = f_set_idx.device
    raw = f_set_idx.to(torch.int64) * w + f_way.to(torch.int64)
    slot = torch.where(f_wrote & (raw < nslots), raw, nslots)
    pos = torch.arange(f, dtype=torch.int32, device=dev)
    # one spare slot past the end takes the dropped entries
    last = torch.full((nslots + 1,), -1, dtype=torch.int32, device=dev)
    last.scatter_reduce_(0, slot, pos, reduce="amax")
    winner = f_wrote & (last[slot.clamp(max=nslots - 1)] == pos)
    return torch.where(winner, slot, nslots).to(torch.int32)


def serve_fused_op(
    ks: torch.Tensor,  # (S, 4W) int32 packed state, updated in place
    value: torch.Tensor,  # (S, W, V) int32 value table, updated in place
    h_hi: torch.Tensor,  # (B,) int32 request hash words (uint32 bits)
    h_lo: torch.Tensor,
    set_idx: torch.Tensor,  # (B,) int32
    admit: torch.Tensor,  # (B,) bool
    static_hit: torch.Tensor,  # (B,) bool
    clock: torch.Tensor,  # () int32
    f_set_idx: Optional[torch.Tensor] = None,  # (F,) deferred fill (None -> empty)
    f_wrote: Optional[torch.Tensor] = None,
    f_way: Optional[torch.Tensor] = None,
    f_values: Optional[torch.Tensor] = None,  # (F, V)
    epochs: Optional[torch.Tensor] = None,
    min_epoch: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One-dispatch serve: deferred-fill apply + fused probe/commit +
    probed value-row gather over the packed state and the value table.

    Everything :func:`probe_and_commit_op` returns, plus ``value`` (the
    post-fill table, the same tensor) and ``values`` (per-request probed
    value rows, arrival order; garbage on misses, as in the reference).
    The fill lands before any value row is read.
    """
    s, w, v = value.shape
    nslots = s * w
    b = h_hi.shape[0]
    dev = ks.device
    epochs, min_epoch = _defaults(b, dev, epochs, min_epoch)
    if b == 0:
        return dict(
            ks=ks, value=value,
            values=torch.zeros((0, v), dtype=value.dtype, device=dev),
            **_empty_result(0, dev),
        )
    if f_set_idx is None:
        f_slot = torch.zeros(0, dtype=torch.int32, device=dev)
        f_vals = torch.zeros((0, v), dtype=torch.int32, device=dev)
    else:
        f_slot = fill_winner_slots(nslots, w, f_set_idx, f_wrote.to(torch.bool), f_way)
        f_vals = _i32(f_values)
    order, _, leader, seg_len, seg_set = plan_segments(_i32(set_idx))
    vals, pre_hit, pre_way, pre_stale, pre_epoch, wrote, way = _serve_fused(
        ks, value.view(nslots, v), f_slot, f_vals, order, leader, seg_len,
        seg_set, _i32(h_hi), _i32(h_lo), admit.to(torch.bool).contiguous(),
        static_hit.to(torch.bool).contiguous(), epochs, min_epoch, _i32(clock),
    )
    return dict(
        ks=ks, value=value, values=vals, pre_hit=pre_hit, pre_way=pre_way,
        pre_stale=pre_stale, pre_epoch=pre_epoch, wrote=wrote, way=way,
    )
