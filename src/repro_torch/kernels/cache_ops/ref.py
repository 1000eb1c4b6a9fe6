"""Plain PyTorch versions of the cache-op kernels.

Each function computes exactly what its CUDA kernel computes, as a
straightforward tensor program on any device:

* :func:`conflict_round` -- one sequential LRU step on evolving rows
  (``repro.kernels.cache_ops.kernel.conflict_round``);
* :func:`probe_and_commit_plain` -- the probe/commit kernel
  (``kernel.py::_kernel``);
* :func:`serve_fused_plain` -- the one-dispatch serve kernel
  (``serve_kernel.py::_serve_kernel``): deferred fill, probe, commit and
  probed value-row gather.

The kernel wrappers run these for tensors on the CPU; ``chip_smoke.py``
holds the kernels against them on the card.

Words are ``torch.int32`` tensors carrying the JAX package's uint32 bits.
Keys only meet ``==``; epochs and freshness floors are compared unsigned
through :func:`u32` (an int64 view), because ``min_epoch`` saturates at
``2**32 - 1`` and a signed view would misorder epochs at or above 2**31.
Stamps are int32 and compare signed, as in the reference.

Like the kernels, both commit functions update ``ks`` (and the serve
function the value table) in place and return the per-request outputs in
arrival order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_U32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding the unsigned 32-bit value."""
    return x.to(torch.int64) & _U32


def bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> its int32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def is_pad(h_hi: torch.Tensor, h_lo: torch.Tensor) -> torch.Tensor:
    """Mask of requests carrying the reserved pad key (all-ones words)."""
    return (h_hi == -1) & (h_lo == -1)


def conflict_round(
    r_hi, r_lo, r_st, r_ep, hi_i, lo_i, admit_i, static_i, ep_i, minep_i,
    stamp_i, act,
):
    """One replay round on evolving ``(n, W)`` rows: the exact sequential
    LRU step, one request per row.

    A hit refreshes the first matching way; an admitted miss evicts the
    first way with the smallest stamp.  A hit whose way's epoch is below
    ``minep_i`` is stale: it refreshes the stamp, and its epoch and value
    slot are rewritten (``refresh``).  Pad requests neither match nor
    write.  Returns ``(r_hi, r_lo, r_st, r_ep, is_hit, way, do_write,
    refresh)``.
    """
    w = r_hi.shape[1]
    ways = torch.arange(w, device=r_hi.device)
    pad_i = is_pad(hi_i, lo_i)
    m = (r_hi == hi_i[:, None]) & (r_lo == lo_i[:, None]) & (r_hi != 0)
    m = m & ~pad_i[:, None]
    is_hit = m.any(dim=1)
    # argmax/argmin return the first index of a tie, like the reference
    way = torch.where(
        is_hit, m.to(torch.int32).argmax(dim=1), r_st.argmin(dim=1)
    ).to(torch.int32)
    sel = ways[None, :] == way[:, None]
    ep_way = r_ep.gather(1, way[:, None].to(torch.int64))[:, 0]
    stale = is_hit & (u32(ep_way) < u32(minep_i))
    do_write = act & ~static_i & ~pad_i & (is_hit | admit_i)
    refresh = do_write & (~is_hit | stale)
    upd = do_write[:, None] & sel
    updv = refresh[:, None] & sel
    r_hi = torch.where(upd, hi_i[:, None], r_hi)
    r_lo = torch.where(upd, lo_i[:, None], r_lo)
    r_st = torch.where(upd, stamp_i[:, None], r_st)
    r_ep = torch.where(updv, ep_i[:, None], r_ep)
    return r_hi, r_lo, r_st, r_ep, is_hit, way, do_write, refresh


def _replay(
    ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
    epochs, min_epoch, clock, value: Optional[torch.Tensor] = None,
):
    """The rounds loop shared by both kernels' plain versions: round ``j``
    applies every segment's ``j``-th request (sequential depth = the
    deepest segment).  ``value`` (flat ``(S*W, V)``) turns on the probed
    value-row gather."""
    b = h_hi.shape[0]
    n_sets, w4 = ks.shape
    w = w4 // 4
    dev = ks.device
    pre_hit = torch.zeros(b, dtype=torch.bool, device=dev)
    pre_way = torch.zeros(b, dtype=torch.int32, device=dev)
    pre_stale = torch.zeros(b, dtype=torch.bool, device=dev)
    pre_epoch = torch.zeros(b, dtype=torch.int32, device=dev)
    wrote = torch.zeros(b, dtype=torch.bool, device=dev)
    way_out = torch.zeros(b, dtype=torch.int32, device=dev)
    vals = None
    if value is not None:
        vals = torch.zeros((b, value.shape[1]), dtype=value.dtype, device=dev)
    if b == 0:
        return vals, pre_hit, pre_way, pre_stale, pre_epoch, wrote, way_out
    # out-of-range sets clamp on the gather and drop on the scatter
    row_i = seg_set.clamp(max=n_sets - 1).to(torch.int64)
    rows = ks[row_i]  # pristine rows, one per segment
    p_hi, p_lo, p_ep = rows[:, :w], rows[:, w : 2 * w], rows[:, 3 * w :]
    r_hi, r_lo = p_hi.clone(), p_lo.clone()
    r_st, r_ep = rows[:, 2 * w : 3 * w].clone(), p_ep.clone()
    for j in range(int(seg_len.max())):
        act = j < seg_len
        idx = (leader + j).clamp(max=b - 1).to(torch.int64)
        pos = order[idx].to(torch.int64)
        hi_i, lo_i = h_hi[pos], h_lo[pos]
        minep = min_epoch[pos]
        # probe against the pristine rows: in-batch duplicates miss
        pm = (p_hi == hi_i[:, None]) & (p_lo == lo_i[:, None]) & (p_hi != 0)
        pm = pm & ~is_pad(hi_i, lo_i)[:, None]
        pm_any = pm.any(dim=1)
        pm_way = pm.to(torch.int32).argmax(dim=1).to(torch.int32)
        pm_ep = torch.where(pm, u32(p_ep), 0).amax(dim=1)
        # effective write epoch: a pristine fresh hit keeps its resident
        # epoch, so a mid-batch evict + re-insert cannot launder its age
        fresh = pm_any & (pm_ep >= u32(minep))
        ep = torch.where(fresh, pm_ep, u32(epochs[pos]))
        stamp = clock + 1 + pos.to(torch.int32)  # int32, wraps like the reference
        r_hi, r_lo, r_st, r_ep, _, way, _, refresh = conflict_round(
            r_hi, r_lo, r_st, r_ep, hi_i, lo_i, admit[pos], static_hit[pos],
            bits32(ep), minep, stamp, act,
        )
        tgt = pos[act]
        pre_hit[tgt] = pm_any[act]
        pre_way[tgt] = pm_way[act]
        pre_stale[tgt] = (pm_any & (pm_ep < u32(minep)))[act]
        pre_epoch[tgt] = bits32(pm_ep)[act]
        wrote[tgt] = refresh[act]
        way_out[tgt] = way[act]
        if value is not None:
            vals[tgt] = value[(row_i * w + pm_way)[act]]
    keep = (seg_len > 0) & (seg_set < n_sets)
    ks[seg_set[keep].to(torch.int64)] = torch.cat([r_hi, r_lo, r_st, r_ep], dim=1)[keep]
    return vals, pre_hit, pre_way, pre_stale, pre_epoch, wrote, way_out


def probe_and_commit_plain(
    ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
    epochs, min_epoch, clock,
) -> Tuple[torch.Tensor, ...]:
    """Probe + conflict-aware commit of one planned batch (see
    :func:`repro_torch.kernels.cache_ops.kernel.probe_and_commit` for the
    arguments).  Updates ``ks`` in place; returns ``(pre_hit, pre_way,
    pre_stale, pre_epoch, wrote, way)`` in arrival order."""
    return _replay(
        ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
        epochs, min_epoch, clock,
    )[1:]


def serve_fused_plain(
    ks, value, f_slot, f_vals, order, leader, seg_len, seg_set, h_hi, h_lo,
    admit, static_hit, epochs, min_epoch, clock,
) -> Tuple[torch.Tensor, ...]:
    """Deferred fill, then probe + commit + probed value-row gather (see
    :func:`repro_torch.kernels.cache_ops.serve_kernel.serve_fused`).
    Updates ``ks`` and the flat value table in place; returns ``(vals,
    pre_hit, pre_way, pre_stale, pre_epoch, wrote, way)``."""
    keep = (f_slot >= 0) & (f_slot < value.shape[0])
    value[f_slot[keep].to(torch.int64)] = f_vals[keep]  # slots are unique
    return _replay(
        ks, order, leader, seg_len, seg_set, h_hi, h_lo, admit, static_hit,
        epochs, min_epoch, clock, value=value,
    )
