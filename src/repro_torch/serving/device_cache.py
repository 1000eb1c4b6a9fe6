"""Device-resident STD cache on PyTorch (port of ``repro.serving.device_cache``).

The paper's topic-partitioned result cache as dense tensors on the card --
a W-way set-associative cache whose address space is partitioned by
topic:

    ks    : (S, 4W) int32   packed per-slot words (uint32 bits): columns
                            [0:W] key_hi, [W:2W] key_lo, [2W:3W] recency
                            stamp, [3W:4W] insertion epoch; key 0 = empty
    value : (S, W, V) int32 cached result payload (doc ids)
    clock : () int32        the commit clock (stamps are clock + 1 + i)

plus the read-only static layer, a sorted hash array (``static_hi``,
``static_lo`` as int32 bits, ``static_value``).  The state is a dict of
tensors with the JAX package's keys and bits; :func:`state_from_numpy` and
:func:`state_to_numpy` carry it across bit for bit.

Topic tau owns the contiguous set range [offset[tau], offset[tau]+sets[tau])
sized by the paper's proportional allocation; the dynamic cache is
partition k.  One key is reserved: ``PAD_KEY`` (query id -1, packed hash
all ones) never hits, is never admitted and never displaces an entry.

Every entry point runs on ``device`` ("cuda" unless the caller passes
"cpu").  On the card the serving step goes through the hand-written
kernels of :mod:`repro_torch.kernels.cache_ops`; on the CPU through their
plain versions.  The serving ops update ``ks`` and ``value`` in place: the
broker owns its state.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.alloc import proportional_allocation
from ..core.device import resolve_device
from ..kernels.cache_ops.ops import (
    PAD_HI as _PAD_HI_INT,
    PAD_LO as _PAD_LO_INT,
    fill_winner_slots,
    probe_and_commit_op,
    serve_fused_op,
)
from ..kernels.cache_ops.ref import is_pad, u32

DYNAMIC = -1  # callers pass topic=-1 for no-topic queries

#: the reserved pad key's packed hash words (host-side numpy uint32)
PAD_HI = np.uint32(_PAD_HI_INT)
PAD_LO = np.uint32(_PAD_LO_INT)
#: the reserved pad key's 64-bit hash -- splitmix64(PAD_KEY) lands here
#: and no real key ever does
PAD_H64 = (np.uint64(PAD_HI) << np.uint64(32)) | np.uint64(PAD_LO)

#: state keys whose words are uint32 in the JAX package
_U32_KEYS = ("ks", "static_hi", "static_lo")
_STATE_KEYS = ("ks", "value", "clock", "static_hi", "static_lo", "static_value")


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix of query ids (host side, numpy uint64).

    Two hash values are reserved and never produced for a real key: 0 is
    the empty-slot sentinel and ``PAD_H64`` is the shape-padding
    sentinel; the astronomically unlikely real key that mixes onto one of
    them is deterministically remapped.  The reserved query id
    ``PAD_KEY`` (= -1) maps *exactly* to ``PAD_H64``.
    """
    x64 = np.asarray(x)
    if x64.dtype != np.uint64:
        # int -> uint64 via astype (C wrap): PAD_KEY == -1 becomes all-ones
        x64 = x64.astype(np.int64, copy=False).astype(np.uint64)
    is_pad = x64 == PAD_H64
    z = x64 + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    z[z == 0] = 1  # 0 is the empty-slot sentinel
    z[z == PAD_H64] = PAD_H64 ^ np.uint64(1)  # the pad hash is reserved
    z[is_pad] = PAD_H64
    return z


def pack_hashes(h64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (h64 >> np.uint64(32)).astype(np.uint32), (h64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def pad_batch(h_hi, h_lo, parts, pad_part: int, bp: int, values=None, admit=None):
    """Extend a request batch to ``bp`` entries with the reserved pad key.

    Pads carry the packed pad hash, route to ``pad_part`` (the partition
    only picks which set an inert probe touches), zero values and
    ``admit=False``.  ``values`` / ``admit`` pass through untouched when
    None.  Returns ``(h_hi, h_lo, parts, values, admit)``; a no-op when
    ``bp <= len``.
    """
    n = len(h_hi)
    if bp > n:
        p = bp - n
        h_hi = np.concatenate([h_hi, np.full(p, PAD_HI, np.uint32)])
        h_lo = np.concatenate([h_lo, np.full(p, PAD_LO, np.uint32)])
        parts = np.concatenate(
            [np.asarray(parts, np.int32), np.full(p, pad_part, np.int32)]
        )
        if values is not None:
            values = np.asarray(values, np.int32)
            values = np.concatenate(
                [values, np.zeros((p, values.shape[1]), np.int32)]
            )
        if admit is not None:
            admit = np.concatenate([np.asarray(admit, bool), np.zeros(p, bool)])
    return h_hi, h_lo, parts, values, admit


def to_device_words(x: np.ndarray, device) -> torch.Tensor:
    """numpy uint32/int32 words -> an int32 tensor with the same bits."""
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.astype(np.int32, copy=False)).to(device)


def state_from_numpy(tree: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A JAX broker's cache state (numpy arrays under the keys ``ks``,
    ``value``, ``clock``, ``static_hi``, ``static_lo``, ``static_value``)
    -> the port's state on ``device``, bit for bit."""
    dev = resolve_device(device)
    out = {}
    for k in _STATE_KEYS:
        arr = np.asarray(tree[k])
        want = np.uint32 if k in _U32_KEYS else np.int32
        if arr.dtype != want:
            raise TypeError(f"state[{k!r}] must be {np.dtype(want)}, got {arr.dtype}")
        out[k] = to_device_words(arr, dev).clone()
    return out


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's state -> numpy arrays with the JAX package's dtypes
    (uint32 words where JAX holds uint32), bit for bit."""
    out = {}
    for k in _STATE_KEYS:
        arr = state[k].detach().cpu().numpy().copy()
        out[k] = arr.view(np.uint32) if k in _U32_KEYS else arr
    return out


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32-bit words -> int64 keys whose signed order is the
    unsigned lexicographic order of the pair (sign bit flipped)."""
    key = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    return key ^ torch.iinfo(torch.int64).min


@dataclasses.dataclass(frozen=True)
class DeviceCacheConfig:
    total_entries: int
    ways: int = 8
    value_dim: int = 8
    #: per-topic entry counts (proportional allocation); dynamic entries
    #: are whatever remains
    topic_entries: Mapping[int, int] = dataclasses.field(default_factory=dict)
    dynamic_entries: int = 0
    static_entries: int = 0

    @classmethod
    def build(
        cls,
        n: int,
        f_s: float,
        f_t: float,
        topic_distinct: Mapping[int, int],
        ways: int = 8,
        value_dim: int = 8,
    ) -> "DeviceCacheConfig":
        n_s = int(round(f_s * n))
        n_t = int(round(f_t * n))
        n_d = n - n_s - n_t
        sizes = proportional_allocation(n_t, topic_distinct, exact=True)
        return cls(
            total_entries=n,
            ways=ways,
            value_dim=value_dim,
            topic_entries=sizes,
            dynamic_entries=n_d,
            static_entries=n_s,
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "total_entries": int(self.total_entries),
                "ways": int(self.ways),
                "value_dim": int(self.value_dim),
                "topic_entries": {
                    str(int(t)): int(c) for t, c in self.topic_entries.items()
                },
                "dynamic_entries": int(self.dynamic_entries),
                "static_entries": int(self.static_entries),
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, s: str) -> "DeviceCacheConfig":
        d = json.loads(s)
        d["topic_entries"] = {int(t): int(c) for t, c in d["topic_entries"].items()}
        return cls(**d)


class STDDeviceCache:
    """The cache's layout and ops; the state is a dict of tensors the
    caller holds (``init_state`` is the empty cache on ``device``).  The
    ops update ``ks`` and ``value`` in place: a holder clones them first,
    as ``Broker`` does, so ``init_state`` stays empty."""

    def __init__(
        self,
        cfg: DeviceCacheConfig,
        static_hashes: Optional[np.ndarray] = None,
        static_values: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        w = cfg.ways
        topics = sorted(cfg.topic_entries)
        self.topic_ids = topics
        self.k = len(topics)
        sets = []
        for t in topics:
            sets.append(max(cfg.topic_entries[t] // w, 1) if cfg.topic_entries[t] > 0 else 0)
        sets.append(max(cfg.dynamic_entries // w, 1) if cfg.dynamic_entries > 0 else 0)
        self.part_sets = np.asarray(sets, dtype=np.int32)
        self.part_offset = np.concatenate([[0], np.cumsum(self.part_sets)]).astype(np.int32)
        self.n_sets = int(self.part_offset[-1])
        #: topic id -> partition index (dynamic = k)
        self.part_of_topic = {t: i for i, t in enumerate(topics)}
        # dense topic -> partition lookup for host routing; topics whose
        # partition got zero sets fall through to the dynamic cache.
        # Sparse/huge topic-id spans keep the per-topic loop instead.
        self._part_lut = None
        self._lut_base = 0
        if topics and int(topics[-1]) - int(topics[0]) < (1 << 20):
            self._lut_base = int(topics[0])  # topics is sorted
            lut = np.full(int(topics[-1]) - self._lut_base + 1, self.k, np.int32)
            for t, i in self.part_of_topic.items():
                lut[t - self._lut_base] = i if self.part_sets[i] > 0 else self.k
            self._part_lut = lut

        if static_hashes is not None and len(static_hashes):
            sh = np.asarray(static_hashes, np.uint64)
            # the empty-slot and pad sentinels can never be static keys
            ok = (sh != 0) & (sh != PAD_H64)
            if static_values is not None:
                static_values = np.asarray(static_values, np.int32)[ok]
            sh = sh[ok]
            order = np.argsort(sh)
            static = sh[order]
            if static_values is None:
                static_values = np.zeros((len(static), cfg.value_dim), np.int32)
            s_vals = np.asarray(static_values, np.int32)[order]
        else:
            static = np.zeros(0, np.uint64)
            s_vals = np.zeros((0, cfg.value_dim), np.int32)
        s_hi, s_lo = pack_hashes(static)
        dev = self.device
        n = max(self.n_sets, 1)
        self.init_state = {
            "ks": torch.zeros((n, 4 * w), dtype=torch.int32, device=dev),
            "value": torch.zeros((n, w, cfg.value_dim), dtype=torch.int32, device=dev),
            "clock": torch.zeros((), dtype=torch.int32, device=dev),
            "static_hi": to_device_words(s_hi, dev),
            "static_lo": to_device_words(s_lo, dev),
            "static_value": torch.from_numpy(s_vals).to(dev),
        }
        self._part_sets_dev = torch.from_numpy(self.part_sets.astype(np.int64)).to(dev)
        self._part_offset_dev = torch.from_numpy(self.part_offset[:-1].astype(np.int64)).to(dev)
        #: the static layer's search keys, memoized per (static_hi,
        #: static_lo) pair: the layer is read-only
        self._static_memo: Tuple = (None, None, None)

    # -- routing ----------------------------------------------------------

    def parts_for(self, topics: np.ndarray) -> np.ndarray:
        """topic ids (host) -> partition indices (dynamic cache = k)."""
        if self._part_lut is None:  # sparse-id fallback
            out = np.full(len(topics), self.k, dtype=np.int32)
            for t, i in self.part_of_topic.items():
                if self.part_sets[i] > 0:
                    out[np.asarray(topics) == t] = i
            return out
        idx = np.asarray(topics, np.int64) - self._lut_base
        ok = (idx >= 0) & (idx < len(self._part_lut))
        return np.where(
            ok, self._part_lut[np.clip(idx, 0, len(self._part_lut) - 1)], self.k
        ).astype(np.int32)

    # -- tensor ops ---------------------------------------------------------

    def _set_index(self, h_lo: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        part = part.to(torch.int64)
        n_sets = self._part_sets_dev[part].clamp(min=1)
        off = self._part_offset_dev[part]
        return (off + u32(h_lo) % n_sets).to(torch.int32)

    def static_lookup(self, state, h_hi: torch.Tensor, h_lo: torch.Tensor):
        """Lower-bound search of each request over the sorted static set
        (unsigned lexicographic order on (hi, lo)).

        Returns (hit mask, index of the matching entry) -- the same index
        the reference's binary search lands on."""
        s_hi, s_lo = state["static_hi"], state["static_lo"]
        n = s_hi.shape[0]
        if n == 0:
            return (
                torch.zeros(h_hi.shape, dtype=torch.bool, device=h_hi.device),
                torch.zeros(h_hi.shape, dtype=torch.int32, device=h_hi.device),
            )
        memo_hi, memo_lo, keys = self._static_memo
        if memo_hi is not s_hi or memo_lo is not s_lo:
            keys = _key64(s_hi, s_lo)
            self._static_memo = (s_hi, s_lo, keys)
        idx = torch.searchsorted(keys, _key64(h_hi, h_lo)).clamp(max=n - 1)
        return (s_hi[idx] == h_hi) & (s_lo[idx] == h_lo), idx.to(torch.int32)

    def _static_fold(self, state, static_hit, static_idx, value, pre_hit):
        """Answer static hits from the static layer; (hit, layer, value)."""
        if state["static_value"].shape[0]:
            value = torch.where(
                static_hit[:, None], state["static_value"][static_idx.to(torch.int64)], value
            )
        hit = static_hit | pre_hit
        layer = torch.where(
            static_hit, 0, torch.where(pre_hit, 1, -1)
        ).to(torch.int32)
        return hit, layer, value

    def probe(self, state, h_hi, h_lo, part, min_epoch=None):
        """Parallel probe: returns (hit, layer, value, stale).

        layer: 0 = static, 1 = set-associative partition, -1 = miss.  Pad
        requests never hit.  ``stale`` marks partition hits whose
        insertion epoch is below the request's ``min_epoch`` floor (static
        entries never expire).
        """
        pad = is_pad(h_hi, h_lo)
        static_hit, static_idx = self.static_lookup(state, h_hi, h_lo)
        static_hit = static_hit & ~pad
        set_idx = self._set_index(h_lo, part).to(torch.int64)
        w = self.cfg.ways
        rows = state["ks"][set_idx]  # (B, 4W): one gather
        keys_hi = rows[:, :w]
        keys_lo = rows[:, w : 2 * w]
        match = (keys_hi == h_hi[:, None]) & (keys_lo == h_lo[:, None]) & (keys_hi != 0)
        match = match & ~pad[:, None]
        way_hit = match.any(dim=1)
        way = match.to(torch.int32).argmax(dim=1)
        if min_epoch is None:
            stale = torch.zeros(h_hi.shape, dtype=torch.bool, device=h_hi.device)
        else:
            ep = torch.where(match, u32(rows[:, 3 * w :]), 0)
            stale = way_hit & (ep.amax(dim=1) < u32(min_epoch))
        value = state["value"][set_idx, way]
        hit, layer, value = self._static_fold(state, static_hit, static_idx, value, way_hit)
        return hit, layer, value, stale

    def _serve_inputs(self, state, h_hi, h_lo, part):
        static_hit, static_idx = self.static_lookup(state, h_hi, h_lo)
        return static_hit & ~is_pad(h_hi, h_lo), static_idx, self._set_index(h_lo, part)

    def probe_and_commit(self, state, h_hi, h_lo, part, admit, epochs=None, min_epoch=None):
        """Fused serve step: probe + key/stamp commit in one kernel launch.

        Returns ``(hit, layer, value, stale, new_state, (set_idx, wrote,
        way))``; ``hit``/``layer``/``value``/``stale`` are those of
        :meth:`probe` against the pre-commit state.  Inserts land keys and
        stamps now; the caller scatters values afterwards with
        :meth:`fill_values`.  ``state["ks"]`` is updated in place.
        """
        b = h_hi.shape[0]
        static_hit, static_idx, set_idx = self._serve_inputs(state, h_hi, h_lo, part)
        out = probe_and_commit_op(
            state["ks"], h_hi, h_lo, set_idx, admit, static_hit, state["clock"],
            epochs=epochs, min_epoch=min_epoch,
        )
        value = state["value"][set_idx.to(torch.int64), out["pre_way"].to(torch.int64)]
        hit, layer, value = self._static_fold(
            state, static_hit, static_idx, value, out["pre_hit"]
        )
        new = dict(state)
        new.update(ks=out["ks"], clock=state["clock"] + b)
        return (
            hit, layer, value, out["pre_stale"], new,
            (set_idx, out["wrote"], out["way"]),
        )

    def fill_probe_and_commit(
        self, state, f_set_idx, f_wrote, f_way, f_values, h_hi, h_lo, part, admit,
        epochs=None, min_epoch=None,
    ):
        """Apply the *previous* batch's deferred value fill, then
        :meth:`probe_and_commit` the current batch."""
        state = self.fill_values(state, f_set_idx, f_wrote, f_way, f_values)
        return self.probe_and_commit(
            state, h_hi, h_lo, part, admit, epochs=epochs, min_epoch=min_epoch,
        )

    def serve_one_call(
        self, state, f_set_idx, f_wrote, f_way, f_values, h_hi, h_lo, part, admit,
        epochs=None, min_epoch=None,
    ):
        """One-dispatch serve step: the previous batch's deferred value
        fill, the atomic probe (with freshness), the conflict-aware commit
        and the probed value-row gather, through :func:`serve_fused_op`
        (one serve-kernel call on the card).

        Same return contract as :meth:`fill_probe_and_commit`, and
        identical results.  The plan must be padded to batch length (pad
        entries carry ``f_wrote == False``).
        """
        b = h_hi.shape[0]
        static_hit, static_idx, set_idx = self._serve_inputs(state, h_hi, h_lo, part)
        out = serve_fused_op(
            state["ks"], state["value"], h_hi, h_lo, set_idx, admit, static_hit,
            state["clock"],
            f_set_idx=f_set_idx, f_wrote=f_wrote, f_way=f_way, f_values=f_values,
            epochs=epochs, min_epoch=min_epoch,
        )
        hit, layer, value = self._static_fold(
            state, static_hit, static_idx, out["values"], out["pre_hit"]
        )
        new = dict(state)
        new.update(ks=out["ks"], value=out["value"], clock=state["clock"] + b)
        return (
            hit, layer, value, out["pre_stale"], new,
            (set_idx, out["wrote"], out["way"]),
        )

    def fill_values(self, state, set_idx, wrote, way, values):
        """Deferred value fill for inserts reported by the fused commit:
        ``values[i]`` lands in slot ``(set_idx[i], way[i])`` for every
        request with ``wrote[i]``, the last writer in batch order winning
        a slot collision.  ``state["value"]`` is updated in place."""
        value = state["value"]
        s, w, v = value.shape
        slot = fill_winner_slots(s * w, w, set_idx, wrote.to(torch.bool), way)
        keep = slot < s * w
        value.view(s * w, v)[slot[keep].to(torch.int64)] = values.to(torch.int32)[keep]
        return dict(state)
