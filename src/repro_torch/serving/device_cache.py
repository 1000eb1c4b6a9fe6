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

Three engines commit a batch, bit-exact with each other and with the JAX
cache's engines of the same names: the sequential oracle (:meth:`commit`,
a plain loop, tests only), the vectorized commit
(:meth:`commit_vectorized`: the ``probe_and_commit`` kernel on the card)
and the numpy host engine (:meth:`commit_host`,
:meth:`probe_and_commit_host`, :meth:`fill_values_host`), which works on
numpy views of a CPU state's memory.  :meth:`repartition` re-splits the
partitions and migrates the live entries (:meth:`extract_live` then
:meth:`bulk_insert` through any engine); :meth:`invalidate_keys` drops
keys.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.alloc import proportional_allocation
from ..core.device import resolve_device
from ..core.spec import PAD_KEY
from ..kernels.cache_ops.ops import (
    PAD_HI as _PAD_HI_INT,
    PAD_LO as _PAD_LO_INT,
    fill_winner_slots,
    probe_and_commit_op,
    serve_fused_op,
    unpack_words,
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


def _unpack_host(ks: np.ndarray):
    """uint32 ``(S, 4W)`` packed words -> writable numpy views ``(key_hi,
    key_lo, stamp, epoch)``; the stamp view is int32, as in the reference."""
    w = ks.shape[-1] // 4
    return ks[:, :w], ks[:, w : 2 * w], ks[:, 2 * w : 3 * w].view(np.int32), ks[:, 3 * w :]


def unpack_state(state) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unpacked ``(key_hi, key_lo, stamp)`` views (int32 bits) of a
    cache state's packed ``ks``."""
    return unpack_words(state["ks"])


def _host_words(x, dtype=np.uint32) -> np.ndarray:
    """A request array (tensor or numpy, int32 or uint32 bits) -> numpy
    words of ``dtype`` with the same bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype.kind in "iu" and a.dtype.itemsize == np.dtype(dtype).itemsize:
        return a.view(dtype)
    return a.astype(dtype)


def _view(t: torch.Tensor, dtype) -> np.ndarray:
    """Numpy words with the bits of state tensor ``t``, to read (its own
    memory on the CPU, a copy from the card)."""
    return t.detach().cpu().numpy().view(dtype)


def _own(t: torch.Tensor, dtype, inplace: bool) -> np.ndarray:
    """A writable numpy array with the bits of state tensor ``t``: its own
    memory when the caller owns the state (``inplace``, the serving
    contract ``state = op(state, ...)``) and ``t`` lies on the CPU, a copy
    otherwise -- a state another holder shares is never written."""
    if inplace and t.device.type == "cpu" and t.is_contiguous():
        return t.detach().numpy().view(dtype)
    return np.array(t.detach().cpu().numpy().view(dtype))


def _as_state(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """numpy words -> an int32 tensor on ``like``'s device (zero-copy on
    the CPU)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def _clock_after(clock, b: int) -> torch.Tensor:
    """The commit clock advanced by a batch of ``b`` (int32, wrapping like
    the reference's)."""
    now = np.asarray(np.int64(int(clock)) + b).astype(np.int32)
    return torch.from_numpy(now).to(clock.device)


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

    #: the reserved never-resident pad key (query-id level; its packed
    #: hash is ``(PAD_HI, PAD_LO)``)
    @property
    def pad_key(self) -> int:
        return PAD_KEY

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

    @classmethod
    def from_spec(
        cls,
        spec,
        topic_distinct: Mapping[int, int],
        ways: int = 8,
        value_dim: int = 8,
    ) -> "DeviceCacheConfig":
        """Compile a :class:`repro_torch.core.spec.CacheSpec` to a device config."""
        return spec.to_device(topic_distinct, ways=ways, value_dim=value_dim)

    @property
    def topic_budget(self) -> int:
        """Total entries owned by the topic layer (invariant under rebalance)."""
        return int(sum(self.topic_entries.values()))

    def rebalanced(self, popularity: Mapping[int, float]) -> "DeviceCacheConfig":
        """Same layer budgets, topic entries re-split by live popularity.

        The static/dynamic layers and the topic layer's *total* budget are
        untouched; only the per-topic split moves (paper Sec. 3.3
        proportional allocation, fed tracked counts instead of training
        distinct counts).  The topic universe is this config's -- topics
        missing from ``popularity`` weigh 0, and a topic given 0 entries
        routes to the dynamic partition.
        """
        weights = {
            int(t): float(popularity.get(int(t), 0.0)) for t in self.topic_entries
        }
        sizes = proportional_allocation(self.topic_budget, weights, exact=True)
        return dataclasses.replace(self, topic_entries=sizes)

    # -- serialization (checkpoints embed the live allocation) --------------

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
        #: the host engine's packed static table, memoized per static_hi
        self._static_host_memo: Tuple = (None, None)

    @classmethod
    def from_spec(
        cls,
        spec,
        stats,
        value_fn=None,
        ways: int = 8,
        value_dim: int = 8,
        device="cuda",
    ) -> "STDDeviceCache":
        """Build the device cache straight from a declarative spec.

        ``stats`` is the :class:`repro_torch.core.fast.VecStats`; the
        static array is preloaded with exactly the spec's always-hit set
        (global static + per-topic static fractions), with values from
        ``value_fn(key_ids) -> (n, value_dim)`` when provided.
        """
        cfg = spec.to_device(stats.topic_distinct, ways=ways, value_dim=value_dim)
        static_keys = spec.device_static_keys(stats)
        static_values = value_fn(static_keys) if value_fn is not None else None
        return cls(
            cfg,
            static_hashes=splitmix64(static_keys) if len(static_keys) else None,
            static_values=static_values,
            device=device,
        )

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

    # -- the sequential oracle ---------------------------------------------

    def commit(self, state, h_hi, h_lo, part, values, admit, epochs=None, min_epoch=None):
        """Serialized batch update preserving exact W-way LRU order.

        Hits refresh stamps; admitted misses evict the LRU way of their
        set.  Items are processed in request order, one at a time, so two
        same-set requests in one batch behave exactly like back-to-back
        requests in the sequential simulator.  This is the *oracle* the
        other engines are held to: a plain loop over numpy words (tests
        only).  Pad requests are inert.  A hit whose resident epoch is
        below ``min_epoch[i]`` is stale: its value slot and epoch are
        rewritten from ``values[i]`` / ``epochs[i]`` (both default to
        zeros -- freshness off).  Returns a new state on the input's
        device; the input is not written.
        """
        h_hi, h_lo, admit, epochs, min_epoch, static_hit, _, set_idx = self._host_batch(
            state, h_hi, h_lo, part, admit, epochs, min_epoch)
        b = len(h_hi)
        vals = _host_words(values, np.int32).reshape(b, -1)
        ks = _own(state["ks"], np.uint32, False)
        value = _own(state["value"], np.int32, False)
        key_hi, key_lo, stamp, epoch = _unpack_host(ks)
        pad = (h_hi == PAD_HI) & (h_lo == PAD_LO)
        s_max = ks.shape[0] - 1
        # reads clamp out-of-range sets, writes drop them (the reference's
        # gather/scatter modes)
        sc = np.minimum(set_idx, s_max)
        # effective write epoch (mirrors probe_and_commit_op): a pristine
        # fresh hit keeps its resident epoch, so a mid-batch evict +
        # re-insert cannot extend the entry's lifetime
        pm0 = (key_hi[sc] == h_hi[:, None]) & (key_lo[sc] == h_lo[:, None]) & (key_hi[sc] != 0)
        pm0 &= ~pad[:, None]
        pm0_ep = np.where(pm0, epoch[sc], 0).max(axis=1)
        epochs = np.where(pm0.any(axis=1) & (pm0_ep >= min_epoch), pm0_ep, epochs)
        clock = np.int64(int(state["clock"]))
        for i in range(b):
            s = int(sc[i])
            match = (key_hi[s] == h_hi[i]) & (key_lo[s] == h_lo[i]) & (key_hi[s] != 0) & ~pad[i]
            is_hit = bool(match.any())
            way = int(match.argmax()) if is_hit else int(stamp[s].argmin())
            stale = is_hit and epoch[s, way] < min_epoch[i]
            do_write = (not static_hit[i] and not pad[i] and (is_hit or admit[i])
                        and set_idx[i] <= s_max)
            if not do_write:
                continue
            key_hi[s, way], key_lo[s, way] = h_hi[i], h_lo[i]
            stamp[s, way] = np.asarray(clock + 1 + i).astype(np.int32)
            if not is_hit or stale:
                epoch[s, way] = epochs[i]
                value[s, way] = vals[i]
        out = dict(state)
        out.update(ks=_as_state(ks, state["ks"]), value=_as_state(value, state["value"]),
                   clock=_clock_after(state["clock"], b))
        return out

    # -- the vectorized engine ---------------------------------------------

    def commit_vectorized(self, state, h_hi, h_lo, part, values, admit, epochs=None,
                          min_epoch=None):
        """Conflict-aware batch commit, bit-exact with :meth:`commit`.

        ``static_lookup`` -> :func:`probe_and_commit_op` (the
        ``probe_and_commit`` kernel on the card, its plain version on the
        CPU) -> :meth:`fill_values`: the batch is stable-sorted by set,
        each set's requests replay in arrival order, and the values land
        by the deferred fill, the last insert (or stale refresh) per slot
        winning -- exactly the order the oracle writes them.  The request
        arguments are tensors on the cache's device; ``ks`` and ``value``
        are updated in place, like the serving ops.
        """
        b = h_hi.shape[0]
        if b == 0:
            return dict(state)
        static_hit, _ = self.static_lookup(state, h_hi, h_lo)
        set_idx = self._set_index(h_lo, part)
        out = probe_and_commit_op(
            state["ks"], h_hi, h_lo, set_idx, admit, static_hit, state["clock"],
            epochs=epochs, min_epoch=min_epoch,
        )
        new = dict(state)
        new.update(ks=out["ks"], clock=state["clock"] + b)
        return self.fill_values(new, set_idx, out["wrote"], out["way"], values)

    # -- the host engine -----------------------------------------------------
    #
    # The same conflict-aware algorithm (stable sort by set, round-by-round
    # segmented replay, gather/compute/scatter), executed by numpy on the
    # CPU, as in the reference.  The state stays the port's (int32 tensors
    # with uint32 bits); the engine works on numpy views of their memory.
    # Bit-exact with `commit` (shared tests).  The reference hands batches
    # deeper than 64 conflicts to its compiled sequential loop; the port
    # has no compiled loop, so it replays every depth by rounds, the rounds
    # found by one stable sort (results are the same either way).

    def _set_index_host(self, h_lo: np.ndarray, part: np.ndarray) -> np.ndarray:
        n_sets = self.part_sets[part]
        off = self.part_offset[part]  # offsets: first k+1 entries of the cumsum
        mod = np.maximum(n_sets.astype(np.uint32), 1)
        return (off + (h_lo.astype(np.uint32) % mod).astype(np.int32)).astype(np.int32)

    def static_lookup_host(self, state, h_hi: np.ndarray, h_lo: np.ndarray):
        src = state["static_hi"]
        if self._static_host_memo[0] is src:
            table = self._static_host_memo[1]
        else:  # read-only layer: packed once, rebuilt only after a restore
            s_hi = _host_words(src).astype(np.uint64)
            s_lo = _host_words(state["static_lo"]).astype(np.uint64)
            table = (s_hi << np.uint64(32)) | s_lo
            self._static_host_memo = (src, table)
        if table.shape[0] == 0:
            z = np.zeros(h_hi.shape, np.int32)
            return np.zeros(h_hi.shape, bool), z
        q = (h_hi.astype(np.uint64) << np.uint64(32)) | h_lo.astype(np.uint64)
        idx = np.searchsorted(table, q)
        idx = np.minimum(idx, len(table) - 1).astype(np.int32)
        return table[idx] == q, idx

    def _resolve_host(
        self, key_hi, key_lo, stamp, epoch, h_hi, h_lo, set_idx, admit, static_hit,
        clock, epochs=None, min_epoch=None,
    ):
        """Segmented replay on host arrays; mutates key/stamp/epoch arrays
        in place.

        Round j applies every set's j-th request -- total work O(B * W),
        and the sorts are numpy's.  Returns the per-request write plan
        ``(wrote, way)`` for the deferred value fill.
        """
        b = len(h_hi)
        if b == 0:
            return np.zeros(0, bool), np.zeros(0, np.int32)
        if epochs is None:
            epochs = np.zeros(b, np.uint32)
        if min_epoch is None:
            min_epoch = np.zeros(b, np.uint32)
        pad = (h_hi == PAD_HI) & (h_lo == PAD_LO)
        s_max = key_hi.shape[0] - 1
        sc = np.minimum(set_idx, s_max)  # reads clamp ...
        oob = set_idx > s_max  # ... and writes drop
        wrote = np.zeros(b, bool)
        way_out = np.zeros(b, np.int32)
        # pads, static hits and out-of-range sets never write and never
        # affect any other request's replay, so they leave the conflict
        # ranking entirely (a bucketed batch can be half pad, and every pad
        # shares one set)
        act = np.flatnonzero(~(pad | static_hit | oob))
        if len(act) == 0:
            return wrote, way_out
        # 16-bit radix argsort when set indices fit
        sc_a = sc[act]
        sort_key = sc_a.astype(np.uint16) if s_max < 0xFFFF else sc_a
        order = act[np.argsort(sort_key, kind="stable")]
        ss_c = sc[order]
        n_act = len(act)
        start = np.empty(n_act, bool)
        start[0] = True
        start[1:] = ss_c[1:] != ss_c[:-1]
        ar = np.arange(n_act)
        rank = ar - np.maximum.accumulate(np.where(start, ar, 0))
        depth = int(rank.max()) + 1
        # the rounds, each in set order: one stable sort by rank
        rank_key = rank.astype(np.uint16) if depth <= 0xFFFF else rank
        by_round = order[np.argsort(rank_key, kind="stable")]
        ends = np.cumsum(np.bincount(rank, minlength=depth))
        # effective write epoch (mirrors probe_and_commit_op), computed
        # against the still-pristine arrays before any round mutates them
        pm0 = (key_hi[sc] == h_hi[:, None]) & (key_lo[sc] == h_lo[:, None]) \
            & (key_hi[sc] != 0)
        pm0 &= ~pad[:, None]
        pm0_ep = np.where(pm0, epoch[sc], 0).max(axis=1)
        epochs = np.where(
            pm0.any(axis=1) & (pm0_ep >= min_epoch), pm0_ep, epochs
        ).astype(np.uint32)
        clock = np.int64(int(clock))
        lo = 0
        for j in range(depth):
            i = by_round[lo : ends[j]]  # round j, one request per set
            lo = ends[j]
            s = sc[i]
            rh, rl, rst = key_hi[s], key_lo[s], stamp[s]
            m = (rh == h_hi[i][:, None]) & (rl == h_lo[i][:, None]) & (rh != 0)
            # one reduction finds both outcomes: a match outranks every
            # stamp (stamps are >= 0), else the LRU way wins; ties keep the
            # first index exactly like the oracle's argmin/argmax
            prio = np.where(m, np.int32(-1), rst)
            way = prio.argmin(axis=1).astype(np.int32)
            is_hit = prio[np.arange(len(i)), way] == -1
            stale = is_hit & (epoch[s, way] < min_epoch[i])
            do_write = is_hit | admit[i]
            refresh = do_write & (~is_hit | stale)
            w = np.flatnonzero(do_write)
            key_hi[s[w], way[w]] = h_hi[i[w]]
            key_lo[s[w], way[w]] = h_lo[i[w]]
            stamp[s[w], way[w]] = (clock + 1 + i[w]).astype(np.int32)
            r = np.flatnonzero(refresh)
            epoch[s[r], way[r]] = epochs[i[r]]
            wrote[i] = refresh
            way_out[i] = way
        return wrote, way_out

    def _host_batch(self, state, h_hi, h_lo, part, admit, epochs, min_epoch):
        """Request arrays as numpy words, with the static lookup and the
        set indices."""
        h_hi, h_lo = _host_words(h_hi), _host_words(h_lo)
        b = len(h_hi)
        epochs = np.zeros(b, np.uint32) if epochs is None else _host_words(epochs)
        min_epoch = np.zeros(b, np.uint32) if min_epoch is None else _host_words(min_epoch)
        static_hit, static_idx = self.static_lookup_host(state, h_hi, h_lo)
        set_idx = self._set_index_host(h_lo, _host_words(part, np.int32))
        return (h_hi, h_lo, _host_words(admit, bool), epochs, min_epoch, static_hit,
                static_idx, set_idx)

    def commit_host(
        self, state, h_hi, h_lo, part, values, admit, epochs=None, min_epoch=None,
        inplace: bool = False,
    ):
        """Numpy engine for :meth:`commit_vectorized`; bit-exact with both.

        With ``inplace`` the caller hands over the state (``state =
        commit_host(state, ...)``) and a CPU state's words are updated in
        their own memory; otherwise the input is not written.
        """
        h_hi, h_lo, admit, epochs, min_epoch, static_hit, _, set_idx = self._host_batch(
            state, h_hi, h_lo, part, admit, epochs, min_epoch)
        b = len(h_hi)
        out = dict(state)
        out["clock"] = _clock_after(state["clock"], b)
        if b == 0:
            return out
        ks = _own(state["ks"], np.uint32, inplace)
        key_hi, key_lo, stamp, epoch = _unpack_host(ks)
        wrote, way = self._resolve_host(
            key_hi, key_lo, stamp, epoch, h_hi, h_lo, set_idx, admit, static_hit,
            state["clock"], epochs=epochs, min_epoch=min_epoch,
        )
        value = _own(state["value"], np.int32, inplace)
        w = np.flatnonzero(wrote & (set_idx <= ks.shape[0] - 1))
        # in order: the last insert wins a slot
        value[set_idx[w], way[w]] = _host_words(values, np.int32).reshape(b, -1)[w]
        out.update(ks=_as_state(ks, state["ks"]), value=_as_state(value, state["value"]))
        return out

    def probe_and_commit_host(
        self, state, h_hi, h_lo, part, admit, epochs=None, min_epoch=None,
        inplace: bool = False,
    ):
        """Numpy engine for :meth:`probe_and_commit`: same contract, on the
        host.  The per-request outputs are numpy arrays; the state stays
        the port's tensors (``inplace`` as in :meth:`commit_host`)."""
        h_hi, h_lo, admit, epochs, min_epoch, static_hit, static_idx, set_idx = (
            self._host_batch(state, h_hi, h_lo, part, admit, epochs, min_epoch))
        b = len(h_hi)
        pad = (h_hi == PAD_HI) & (h_lo == PAD_LO)
        static_hit = static_hit & ~pad
        ks = _own(state["ks"], np.uint32, inplace)
        w = self.cfg.ways
        s_max = ks.shape[0] - 1
        sc = np.minimum(set_idx, s_max)
        rows = ks[sc]  # (B, 4W): one gather for keys, stamps and epochs
        pre_rh = rows[:, :w]
        pre_rl = rows[:, w : 2 * w]
        pm = (pre_rh == h_hi[:, None]) & (pre_rl == h_lo[:, None]) & (pre_rh != 0)
        pm &= ~pad[:, None]
        pre_hit = pm.any(axis=1)
        pre_way = pm.argmax(axis=1).astype(np.int32)
        pre_ep = np.where(pm, rows[:, 3 * w :], 0).max(axis=1)
        pre_stale = pre_hit & (pre_ep < min_epoch)
        value = _view(state["value"], np.int32)[sc, pre_way]
        s_vals = state["static_value"]
        if s_vals.shape[0]:
            value = np.where(static_hit[:, None], _view(s_vals, np.int32)[static_idx], value)
        key_hi, key_lo, stamp, epoch = _unpack_host(ks)
        wrote, way = self._resolve_host(
            key_hi, key_lo, stamp, epoch, h_hi, h_lo, set_idx, admit, static_hit,
            state["clock"], epochs=epochs, min_epoch=min_epoch,
        )
        hit = static_hit | pre_hit
        layer = np.where(static_hit, 0, np.where(pre_hit, 1, -1)).astype(np.int32)
        new = dict(state)
        new.update(ks=_as_state(ks, state["ks"]), clock=_clock_after(state["clock"], b))
        return hit, layer, value, pre_stale, new, (set_idx, wrote, way)

    def fill_values_host(self, state, set_idx, wrote, way, values, inplace: bool = False):
        value = _own(state["value"], np.int32, inplace)
        set_idx = _host_words(set_idx, np.int32)
        w = np.flatnonzero(_host_words(wrote, bool) & (set_idx <= value.shape[0] - 1))
        value[set_idx[w], _host_words(way, np.int32)[w]] = _host_words(values, np.int32)[w]
        out = dict(state)
        out["value"] = _as_state(value, state["value"])
        return out

    # -- elastic re-partitioning -------------------------------------------

    def repartition(
        self, state, new_cfg: DeviceCacheConfig, engine: str = "vec", bucket=None,
    ) -> Tuple["STDDeviceCache", Dict[str, torch.Tensor]]:
        """Rebuild the partition table (e.g., fresh topic popularity) and
        migrate resident entries, preserving recency order.

        Live entries are bulk-inserted into the new layout oldest-first so
        the newest survive a shrinking partition -- exactly the eviction
        order a sequential replay would produce.  The static layer is
        read-only and carried over untouched (hashes *and* values); the
        new clock restarts at the migration batch's length, and stamps stay
        strictly increasing in migration order.

        ``engine`` picks the bulk-insert path: ``"vec"``
        (:meth:`commit_vectorized`: the ``probe_and_commit`` kernel on the
        card), ``"host"`` (the numpy engine) or ``"oracle"`` (the
        sequential loop) -- all bit-exact with each other, so a live
        rebalance lands the same state whichever engine the broker serves
        with.  ``bucket`` (a :class:`repro_torch.serving.spec.BucketSpec`)
        pads the migration batch up to its shape bucket with the reserved
        pad key, as the reference does; pad migrants are inert, and the
        clock counts them.  The input state is not written.
        """
        if engine not in ("vec", "host", "oracle"):
            raise ValueError(f"engine must be vec|host|oracle, got {engine!r}")
        new_cache = STDDeviceCache(new_cfg, static_hashes=None, device=self.device)
        new_state = {k: v.clone() for k, v in new_cache.init_state.items()
                     if k in ("ks", "value", "clock")}
        for k in ("static_hi", "static_lo", "static_value"):
            new_state[k] = state[k]
        h64, topics, vals, eps, _ = self.extract_live(state)
        new_state = new_cache.bulk_insert(
            new_state, h64, topics, vals, epochs=eps, engine=engine, bucket=bucket
        )
        return new_cache, new_state

    def extract_live(self, state):
        """Live dynamic/topic-layer entries of ``state``, oldest-first.

        Returns numpy ``(h64, topics, values, epochs, stamps)``: the 64-bit
        hashes reassembled from the stored key words, the recovered topics
        (:data:`DYNAMIC` for dynamic-partition entries), the cached values,
        the insertion epochs, and the recency stamps, sorted by stamp
        ascending -- the replay order a bulk insert needs so the newest
        entries survive a shrinking target.  Stamps are unique among live
        entries (each write takes its own), so any sort gives this order.
        The static layer is excluded: it is read-only and rebuilt at
        deploy time, not migrated.
        """
        key_hi, key_lo, stamp, epoch = _unpack_host(_view(state["ks"], np.uint32))
        value = _view(state["value"], np.int32)
        # partition of each old set
        old_part = np.searchsorted(self.part_offset[1:], np.arange(self.n_sets), side="right")
        live = key_hi != 0
        order = np.argsort(stamp[live])  # oldest first so newest survive
        sets_l, ways_l = np.nonzero(live)
        sets_l, ways_l = sets_l[order], ways_l[order]
        h64 = (key_hi[sets_l, ways_l].astype(np.uint64) << np.uint64(32)) | key_lo[
            sets_l, ways_l
        ].astype(np.uint64)
        parts = old_part[sets_l].astype(np.int32)
        topics = np.full(len(parts), DYNAMIC, dtype=np.int64)
        for t, i in self.part_of_topic.items():
            topics[parts == i] = t
        return (
            h64,
            topics,
            value[sets_l, ways_l],
            epoch[sets_l, ways_l].astype(np.uint32),
            stamp[sets_l, ways_l].astype(np.int64),
        )

    def bulk_insert(
        self, state, h64, topics, values, epochs=None, engine: str = "vec", bucket=None,
    ):
        """Insert pre-hashed entries through a commit engine, in order.

        The insertion half of :meth:`repartition`: entries arrive as
        ``(h64, topic, value[, epoch])`` tuples (typically from
        :meth:`extract_live`) and land through the same bucket-padded
        commit path a live migration uses, so a bulk insert is bit-exact
        with serving the entries as admitted misses in that order.  A
        topic whose partition has no sets routes to the dynamic partition,
        as :meth:`parts_for` routes its requests.  Inserted entries keep
        their insertion epochs: a migration moves capacity, it does not
        renew TTLs.  Returns the new state; on ``"vec"`` the input's words
        are updated in place.
        """
        if engine not in ("vec", "host", "oracle"):
            raise ValueError(f"engine must be vec|host|oracle, got {engine!r}")
        h64 = np.asarray(h64, np.uint64)
        parts = self.parts_for(np.asarray(topics, np.int64))
        hi, lo = pack_hashes(h64)
        vals = np.asarray(values, np.int32).reshape(len(hi), self.cfg.value_dim)
        eps = (
            np.asarray(epochs, np.uint32)
            if epochs is not None
            else np.zeros(len(hi), np.uint32)
        )
        admit = np.ones(len(hi), bool)
        # the reference's static-shape contract: pad the batch to its bucket
        bp = bucket.padded_len(len(hi)) if bucket is not None else len(hi)
        n_real = len(hi)
        hi, lo, parts, vals, admit = pad_batch(
            hi, lo, parts, self.k, bp, values=vals, admit=admit
        )
        if bp > n_real:
            eps = np.concatenate([eps, np.zeros(bp - n_real, np.uint32)])
        if engine == "host":
            return self.commit_host(state, hi, lo, parts, vals, admit, epochs=eps,
                                    inplace=True)
        if engine == "oracle":
            return self.commit(state, hi, lo, parts, vals, admit, epochs=eps)
        dev = state["ks"].device
        return self.commit_vectorized(
            state, to_device_words(hi, dev), to_device_words(lo, dev),
            torch.from_numpy(parts).to(dev), torch.from_numpy(vals).to(dev),
            torch.from_numpy(admit).to(dev), epochs=to_device_words(eps, dev),
        )

    # -- control-plane invalidation ----------------------------------------

    def invalidate_keys(self, state, h_hi, h_lo, part) -> Tuple[Dict[str, torch.Tensor], int]:
        """Point invalidation: zero the key words of matching resident
        slots (key 0 = empty), leaving stamps/epochs/values to be
        overwritten by the next insert.

        Control-plane traffic, far rarer than serves: a handful of tensor
        ops on the state's device, no kernel.  Duplicated keys in the
        batch are idempotent.  Returns ``(new_state, n_slots_zeroed)``; the
        input state is not written.
        """
        ks = state["ks"]
        dev = ks.device
        h_hi = to_device_words(_host_words(h_hi), dev)
        h_lo = to_device_words(_host_words(h_lo), dev)
        part = torch.from_numpy(_host_words(part, np.int32).copy()).to(dev)
        w = self.cfg.ways
        set_idx = self._set_index(h_lo, part).to(torch.int64)
        s_max = ks.shape[0] - 1
        sc = set_idx.clamp(max=s_max)
        rows = ks[sc]
        m = (rows[:, :w] == h_hi[:, None]) & (rows[:, w : 2 * w] == h_lo[:, None]) \
            & (rows[:, :w] != 0)
        m &= ~(is_pad(h_hi, h_lo) | (set_idx > s_max))[:, None]
        req, way = m.nonzero(as_tuple=True)
        n = int(torch.unique(sc[req] * w + way).numel())
        ks = ks.clone()
        ks[sc[req], way] = 0
        ks[sc[req], w + way] = 0
        out = dict(state)
        out["ks"] = ks
        return out, n
