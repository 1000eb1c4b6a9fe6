"""Sequential numpy oracles of the cache ops: the port's copy of
``repro.kernels.cache_ops.ref`` (jax-free there too), same arguments, same
integer semantics.

:func:`probe_and_commit_ref` replays ``STDDeviceCache.commit``'s loop one
request at a time on uint32 key words and int32 stamps, recording the
probe outcome against the pre-commit state (the broker's "atomic batch
probe") and, per request, whether it wrote and into which way -- the plan
the deferred value fill needs.  :func:`serve_fused_ref` applies a deferred
fill plan first and gathers each request's probed value row after it.

Requests carrying the reserved pad key (hash words ``(PAD_HI, PAD_LO)``)
never hit, are never admitted and never displace a resident entry.  The
torch plain versions the kernels are held to live in :mod:`.ref`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .ops import PAD_HI, PAD_LO


def probe_and_commit_ref(
    key_hi: np.ndarray,  # (S, W) uint32
    key_lo: np.ndarray,  # (S, W) uint32
    stamp: np.ndarray,  # (S, W) int32
    h_hi: np.ndarray,  # (B,) uint32
    h_lo: np.ndarray,  # (B,) uint32
    set_idx: np.ndarray,  # (B,) int32
    admit: np.ndarray,  # (B,) bool
    static_hit: np.ndarray,  # (B,) bool
    clock: int,
    epoch: np.ndarray = None,  # (S, W) uint32 insertion epochs (None -> 0)
    epochs: np.ndarray = None,  # (B,) uint32 write epochs (None -> 0)
    min_epoch: np.ndarray = None,  # (B,) uint32 freshness floors (None -> 0)
) -> Dict[str, np.ndarray]:
    key_hi = np.array(key_hi, np.uint32)
    key_lo = np.array(key_lo, np.uint32)
    stamp = np.array(stamp, np.int32)
    epoch = np.zeros(key_hi.shape, np.uint32) if epoch is None else np.array(epoch, np.uint32)
    b = len(h_hi)
    epochs = np.zeros(b, np.uint32) if epochs is None else np.asarray(epochs, np.uint32)
    min_epoch = np.zeros(b, np.uint32) if min_epoch is None else np.asarray(min_epoch, np.uint32)
    pre_hi, pre_lo, pre_ep = key_hi.copy(), key_lo.copy(), epoch.copy()
    s_max = key_hi.shape[0] - 1
    pre_hit = np.zeros(b, bool)
    pre_way = np.zeros(b, np.int32)
    pre_stale = np.zeros(b, bool)
    pre_epoch = np.zeros(b, np.uint32)
    wrote = np.zeros(b, bool)
    way_w = np.zeros(b, np.int32)
    clock = int(clock)
    for i in range(b):
        s = min(int(set_idx[i]), s_max)  # gathers clamp; scatters drop
        oob = int(set_idx[i]) > s_max
        pad = bool(h_hi[i] == np.uint32(PAD_HI)) and bool(h_lo[i] == np.uint32(PAD_LO))
        pm = (pre_hi[s] == h_hi[i]) & (pre_lo[s] == h_lo[i]) & (pre_hi[s] != 0)
        pm &= not pad
        pre_hit[i] = pm.any()
        pre_way[i] = int(pm.argmax())
        pre_epoch[i] = np.where(pm, pre_ep[s], 0).max()
        pre_stale[i] = bool(pm.any()) and int(pre_epoch[i]) < int(min_epoch[i])
        m = (key_hi[s] == h_hi[i]) & (key_lo[s] == h_lo[i]) & (key_hi[s] != 0)
        m &= not pad
        is_hit = bool(m.any())
        way = int(m.argmax()) if is_hit else int(stamp[s].argmin())
        stale = is_hit and int(epoch[s, way]) < int(min_epoch[i])
        do_write = (not static_hit[i]) and (not pad) and (is_hit or bool(admit[i]))
        refresh = do_write and ((not is_hit) or stale)
        if do_write and not oob:
            key_hi[s, way] = h_hi[i]
            key_lo[s, way] = h_lo[i]
            stamp[s, way] = clock + 1 + i
        if refresh and not oob:
            # the effective write epoch: a pristine fresh hit keeps its
            # resident epoch, so a mid-batch evict + re-insert cannot
            # launder the entry's age
            if pre_hit[i] and not pre_stale[i]:
                epoch[s, way] = pre_epoch[i]
            else:
                epoch[s, way] = epochs[i]
        wrote[i] = refresh
        way_w[i] = way
    return dict(
        key_hi=key_hi, key_lo=key_lo, stamp=stamp, epoch=epoch, pre_hit=pre_hit,
        pre_way=pre_way, pre_stale=pre_stale, pre_epoch=pre_epoch, wrote=wrote, way=way_w,
    )


def serve_fused_ref(
    key_hi: np.ndarray,  # (S, W) uint32
    key_lo: np.ndarray,  # (S, W) uint32
    stamp: np.ndarray,  # (S, W) int32
    value: np.ndarray,  # (S, W, V) value table
    h_hi: np.ndarray,  # (B,) uint32
    h_lo: np.ndarray,  # (B,) uint32
    set_idx: np.ndarray,  # (B,) int32
    admit: np.ndarray,  # (B,) bool
    static_hit: np.ndarray,  # (B,) bool
    clock: int,
    epoch: np.ndarray = None,  # (S, W) uint32 insertion epochs (None -> 0)
    epochs: np.ndarray = None,  # (B,) uint32 write epochs (None -> 0)
    min_epoch: np.ndarray = None,  # (B,) uint32 freshness floors (None -> 0)
    f_set_idx: np.ndarray = None,  # deferred-fill plan (None -> empty)
    f_wrote: np.ndarray = None,
    f_way: np.ndarray = None,
    f_values: np.ndarray = None,  # (F, V)
) -> Dict[str, np.ndarray]:
    """Sequential oracle of the one-dispatch serve: the deferred fill in
    arrival order (the last writer to a slot wins), then
    :func:`probe_and_commit_ref`, then each request's probed value row from
    the post-fill table.  Out-of-range fill slots drop and out-of-range set
    indices clamp on the gather."""
    value = np.array(value)
    w = value.shape[1]
    flat = value.reshape(-1, value.shape[2])
    if f_set_idx is not None:
        for i in range(len(f_set_idx)):
            if bool(f_wrote[i]):
                slot = int(f_set_idx[i]) * w + int(f_way[i])
                if 0 <= slot < flat.shape[0]:
                    flat[slot] = f_values[i]
    out = probe_and_commit_ref(
        key_hi, key_lo, stamp, h_hi, h_lo, set_idx, admit, static_hit, clock,
        epoch=epoch, epochs=epochs, min_epoch=min_epoch,
    )
    b = len(h_hi)
    s_max = value.shape[0] - 1
    values = np.zeros((b, value.shape[2]), value.dtype)
    for i in range(b):
        values[i] = value[min(int(set_idx[i]), s_max), int(out["pre_way"][i])]
    return dict(out, value=value, values=values)
